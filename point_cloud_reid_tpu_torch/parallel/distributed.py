"""Process groups and the collectives of data-parallel training.

Port of point_cloud_reid_tpu/parallel/distributed.py (init_distributed,
allgather_results, barrier, dp_step_check). The JAX package runs one SPMD
program over the global batch and XLA inserts the collectives; here every
process runs the train step on its own rows and the terms that couple rows
are reduced explicitly, so that a step over W processes computes the one
step over the global batch:

  global_sum(x)      differentiable all-reduce (sum) of per-rank partial
                     sums: BatchNorm's sums, sums of squares and counts,
                     the fused SA chain's population sums. Its backward
                     all-reduces the upstream gradient, which is right when
                     each rank's loss is its SHARE of the global loss (the
                     shares sum to it): train/losses.py divides each rank's
                     numerator by the global denominator.
  global_total(x)    the same without a gradient (the losses' denominators,
                     the logged metrics).
  gather_rows(x)     differentiable concatenation of every rank's rows
                     (the triplet loss's negatives index the global batch).
  reduce_gradients   one all-reduce (sum) of all gradients in one flat
                     buffer: the sum of the ranks' share gradients is the
                     global batch's gradient.

Every collective is an all-reduce: gloo reduces CUDA tensors but gathers
only CPU ones, and NCCL the reverse, so one primitive serves both backends.
The reductions are active inside `data_parallel()` only (the train step of
a distributed Trainer); everywhere else each function is the identity.

A checkpointed stage (train/loop.py's remat, the backbone's remat_stages)
runs its forward again in the backward. Its statistics must not be reduced a
second time: `recording(tape)` keeps each global_sum result of the forward
and `replaying(tape)` hands them back in the same order to the recompute,
which issues no collective (models/layers.stage_checkpoint).
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# torchrun's environment: with it a process joins a group
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

# the process group of the running data-parallel train step
_GROUP = None
# global_sum results of a checkpointed forward, and their replay
_TAPE: Optional[list] = None
_REPLAY: Optional[Iterator[torch.Tensor]] = None


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    """torchrun's LOCAL_RANK (0 without torchrun)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device: str = "cuda",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> Dict[str, int]:
    """Join the process group when this process was launched into one.

    With torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; LOCAL_RANK picks the card) or an explicit `init_method`
    (e.g. "file:///path", a FileStore), the process group is initialised,
    world size 1 included; without either it is a no-op that reports one
    process. A second call returns the group that is already there.

    backend: "nccl" or "gloo"; by default "nccl" when `device` is CUDA and
    "gloo" for the CPU. It is never switched: a backend that cannot start
    raises.

    Returns process_index, process_count, local_devices (the devices this
    process drives: one in a group, every visible card otherwise) and
    global_devices (the sum over processes)."""
    launched = init_method is not None or all(k in os.environ
                                              for k in _LAUNCH_ENV)
    if launched and not is_distributed():
        if backend is None:
            backend = ("nccl" if torch.device(device).type == "cuda"
                       else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(local_rank())
        kw = dict(backend=backend, timeout=timeout)
        if init_method is not None:
            kw.update(init_method=init_method, world_size=world_size,
                      rank=rank)
        dist.init_process_group(**kw)
    if is_distributed():
        return dict(process_index=dist.get_rank(),
                    process_count=dist.get_world_size(), local_devices=1,
                    global_devices=dist.get_world_size())
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    n = max(n, 1)
    return dict(process_index=0, process_count=1, local_devices=n,
                global_devices=n)


def backend_device() -> torch.device:
    """Where a tensor must lie for the group's backend: the process's card
    for NCCL, the CPU for gloo (which also reduces CUDA tensors)."""
    if is_distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "barrier") -> None:
    """Every process waits here for the others (a no-op in one process).
    `name` is kept for the JAX signature."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def allgather_results(results: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """Every process's per-pair eval arrays, concatenated along axis 0
    process by process (rank 0's rows first); the identity in one
    process."""
    if process_count() == 1:
        return results
    gathered: List[Optional[dict]] = [None] * process_count()
    dist.all_gather_object(gathered, {k: np.asarray(v)
                                      for k, v in results.items()})
    return {k: np.concatenate([g[k] for g in gathered], axis=0)
            for k in results}


# ---- the data-parallel step's reductions --------------------------------------

@contextlib.contextmanager
def data_parallel() -> Iterator[None]:
    """Inside the block the reductions below act over the default group:
    the forward, the loss and the backward of a data-parallel step."""
    global _GROUP
    prev = _GROUP
    _GROUP = dist.group.WORLD
    try:
        yield
    finally:
        _GROUP = prev


def dp_active() -> bool:
    return _GROUP is not None


def dp_size() -> int:
    """The number of processes of the data-parallel step (1 outside one);
    each holds as many rows as the others (shard_batch)."""
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


def dp_group():
    """The data-parallel step's process group (None outside one): a
    custom backward keeps it from its forward, since the backward may run
    outside the data_parallel() block."""
    return _GROUP


def group_total(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over `group` (a new tensor), t itself for None."""
    if group is None:
        return t
    return _all_reduce(t.detach().clone(), group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the group, in place (a CPU tensor of an NCCL group
    goes through the card)."""
    if t.device.type == "cpu" and dist.get_backend(group) == "nccl":
        dev = t.to(backend_device())
        dist.all_reduce(dev, group=group)
        t.copy_(dev)
    else:
        dist.all_reduce(t, group=group)
    return t


class _GlobalSum(torch.autograd.Function):
    """The all-reduce (sum) of x; `replayed` stands for the collective's
    result in a checkpoint's recompute. Backward: the all-reduce of the
    gradient."""

    @staticmethod
    def forward(ctx, x, replayed, group):
        ctx.group = group
        if replayed is not None:
            return replayed.clone()
        return _all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data-parallel group, differentiably; x itself
    outside data_parallel()."""
    if _GROUP is None:
        return x
    if _REPLAY is not None:
        return _GlobalSum.apply(x, next(_REPLAY), _GROUP)
    out = _GlobalSum.apply(x, None, _GROUP)
    if _TAPE is not None:
        _TAPE.append(out.detach())
    return out


def global_total(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data-parallel group, without a gradient."""
    return group_total(x, _GROUP)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        ctx.group, ctx.rank, ctx.world = group, rank, world
        buf = x.new_zeros((world,) + tuple(x.shape))
        buf[rank] = x
        _all_reduce(buf, group)
        return buf.reshape((world * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g.contiguous().clone(), ctx.group)
        return g.reshape((ctx.world, -1) + tuple(g.shape[1:]))[ctx.rank], \
            None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's x (the same shape on each) concatenated along axis 0 in
    rank order; differentiable (a rank's rows get the gradient that every
    rank's loss gives them). x itself outside data_parallel()."""
    if _GROUP is None:
        return x
    return _GatherRows.apply(x, _GROUP)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of a global (W * n, ...) tensor."""
    if _GROUP is None:
        return x
    rank, world = dist.get_rank(_GROUP), dist.get_world_size(_GROUP)
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def reduce_gradients(grads: List[torch.Tensor]) -> None:
    """Sum the gradients over the group in place, in one all-reduce of one
    flat buffer (a bucket of every gradient)."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat, dist.group.WORLD)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def reduce_logs(log: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's shares of the logged values summed over the group (one
    all-reduce), in float32, or float64 when a value is."""
    if not log:
        return log
    keys = list(log)
    dt = (torch.float64 if any(v.dtype == torch.float64 for v in log.values())
          else torch.float32)
    vec = torch.stack([log[k].detach().to(dt).reshape(()) for k in keys])
    _all_reduce(vec, dist.group.WORLD)
    return dict(zip(keys, vec.unbind()))


@contextlib.contextmanager
def recording(tape: list) -> Iterator[None]:
    """global_sum results inside the block are appended to `tape`."""
    global _TAPE
    prev, _TAPE = _TAPE, tape
    try:
        yield
    finally:
        _TAPE = prev


@contextlib.contextmanager
def replaying(tape: list) -> Iterator[None]:
    """global_sum inside the block returns the entries of `tape` in order
    and issues no collective."""
    global _REPLAY
    prev, _REPLAY = _REPLAY, iter(tape)
    try:
        yield
    finally:
        _REPLAY = prev


# ---- the multi-process correctness check --------------------------------------

def dp_step_check(batch_per_device: int = 2,
                  device: Optional[torch.device] = None) -> float:
    """One deterministic data-parallel train step -> the global reid_loss.

    The flagship at mul=1 and backbone_list [16, 8, 4], 16-point crops, a
    global batch of batch_per_device rows per process from a fixed seed;
    each process trains on its contiguous rows (shard_batch) of weights
    built from a fixed seed and broadcast from rank 0 (replicated). Run by
    W processes it must give what one process gives on the whole batch."""
    from ..configs import get_experiment
    from ..models import build_model
    from ..train import ScheduleConfig, TrainState, make_train_step, to_device
    from .mesh import make_mesh, replicated, shard_batch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dp_step_check needs a CUDA device "
                               "(device='cpu' runs it on the CPU)")
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_experiment("pts_point-transformer_point-cat_nus_det_4x256_500e")
    mcfg = dict(cfg["model"])
    mcfg["backbone"] = dict(mcfg["backbone"], mul=1)
    mcfg["backbone_list"] = [16, 8, 4]
    model = build_model(mcfg, device=device,
                        generator=torch.Generator().manual_seed(2))

    B, N = batch_per_device * process_count(), 16
    rs = np.random.RandomState(0)
    full = dict(
        sparse_1=rs.randn(B, N, 3).astype(np.float32),
        sparse_2=rs.randn(B, N, 3).astype(np.float32),
        label_1=np.zeros((B,), np.int32),
        label_2=np.ones((B,), np.int32),
        id_1=np.arange(B, dtype=np.int32),
        id_2=np.arange(B, dtype=np.int32) % 3,
    )
    state = TrainState.create(model, ScheduleConfig(max_epochs=1), 10)
    mesh = make_mesh(devices=[device] * process_count())
    replicated(state.model, state.optimizer)
    step = make_train_step(model, dict(match=True), {})
    batch = to_device(shard_batch(mesh, full), device)
    _, log = step(state, batch, torch.Generator(device=device).manual_seed(3))
    return float(log["reid_loss"])
