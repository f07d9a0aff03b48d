"""One rank of tests/test_torch_parallel.py's two-process run, and the
one-process runs it is held against.

    python -m tests._torch_dp_worker RANK WORLD STORE OUT_DIR

joins a gloo group of WORLD processes through a FileStore at STORE
(init_distributed(init_method="file://...")), runs every scenario below on
its shard of each global batch and writes its results to
OUT_DIR/rank{RANK}.pt. The same functions called without a group are the
one-process references. Nothing here imports jax: the JAX side of the
comparisons lives in the test file, which hands the triplet negatives over
in OUT_DIR/inputs.pt.
"""
from __future__ import annotations

import copy
import datetime
import json
import os
import sys

import numpy as np
import torch

# the model of JAX's tests/test_parallel.py
TINY = dict(
    type="ReIDNet",
    backbone=dict(type="Pointnet_Backbone", input_channels=0, use_xyz=True,
                  conv_out=8, mul=1, nsample=[4, 4, 4]),
    match_head=[dict(type="LinearRes", n_in=16, n_out=16, norm="GN", ng=8),
                dict(type="Linear", out_features=1)],
    cross_stage1=dict(type="corss_attention", d_model=8, nhead=2),
    cross_stage2=dict(type="corss_attention", d_model=8, nhead=2),
    match_type="xcorr_eff", pool_type="both", combine="point-cat",
    backbone_list=[8, 4, 2], output_sequence_size=8, hidden_size=16,
)
TINY_USE = dict(match=True, triplet=True)
SCHED = dict(lr=3e-4, max_epochs=2, grad_clip_norm=35.0)
GLOBAL_B = 16
FIT_USE = dict(match=True, kl=True, triplet=True, cls=True, fp=True)
FIT_PAIRS, FIT_STEPS, EVAL_BATCHES = 8, 3, 2
TIMEOUT = datetime.timedelta(seconds=60)


def tiny_batch(seed: int = 3, B: int = GLOBAL_B, N: int = 8) -> dict:
    """A global numpy batch for TINY: random crops, ids with matches and
    non-matches."""
    rs = np.random.RandomState(seed)
    id_1 = np.arange(B, dtype=np.int32)
    id_2 = np.where(np.arange(B) % 2 == 0, id_1, (id_1 + 1) % B).astype(
        np.int32)
    return dict(sparse_1=rs.randn(B, N, 3).astype(np.float32),
                sparse_2=rs.randn(B, N, 3).astype(np.float32),
                label_1=np.zeros((B,), np.int32),
                label_2=np.ones((B,), np.int32), id_1=id_1, id_2=id_2)


def _rows(batch: dict) -> dict:
    from point_cloud_reid_tpu_torch.parallel import make_mesh, shard_batch
    from point_cloud_reid_tpu_torch.parallel.distributed import process_count
    return shard_batch(make_mesh(devices=["cpu"] * process_count()), batch)


def _weights(model) -> dict:
    return {k: v.detach().double().clone() for k, v in
            model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def tiny_step(neg: torch.Tensor, steps: int = 1) -> dict:
    """TINY in float64, `steps` steps on the same global batch with the
    given global negatives: logs and weights after each step."""
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig, TrainState,
                                                  make_train_step, to_device)
    model = build_model(copy.deepcopy(TINY),
                        generator=torch.Generator().manual_seed(0)).double()
    state = TrainState.create(model, ScheduleConfig(**SCHED), 3)
    step = make_train_step(model, TINY_USE, {}, monitor=True)
    tb = {k: v.double() if v.is_floating_point() else v
          for k, v in to_device(_rows(tiny_batch()), "cpu").items()}
    out = []
    for _ in range(steps):
        _, log = step(state, tb, None, neg)
        out.append(dict(log={k: float(v) for k, v in log.items()},
                        weights=_weights(model)))
    return dict(steps=out)


def knob_model(dtype=torch.float32, **backbone):
    """The flagship-shaped tiny model with both kernel knobs on (their
    plain versions on the CPU), its backbone knobs set."""
    from point_cloud_reid_tpu_torch.models import build_model
    from tests._torch_port import KNOBS, tiny_cfg
    cfg = tiny_cfg(**KNOBS)
    cfg["backbone"] = dict(cfg["backbone"], **backbone)
    return build_model(cfg, generator=torch.Generator().manual_seed(0)).to(
        dtype)


class _Loader:
    """This process's shard of seeded synthetic batches, float arrays in
    `dtype`."""

    def __init__(self, batches: int, seed: int, dtype):
        from point_cloud_reid_tpu_torch.parallel.distributed import (
            process_count, process_index)
        from point_cloud_reid_tpu_torch.train import SyntheticPairLoader
        self.inner = SyntheticPairLoader(
            FIT_PAIRS, batches, num_points=32, num_objects=12,
            num_classes=20, seed=seed, shard_id=process_index(),
            num_shards=process_count())
        self.dtype = dtype

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def __iter__(self):
        for b in self.inner:
            yield {k: v.astype(self.dtype) if v.dtype.kind == "f" else v
                   for k, v in b.items()}


def fit_and_eval(work_dir: str, dtype=torch.float64,
                 steps: int = FIT_STEPS) -> dict:
    """Trainer.fit for `steps` steps of FIT_PAIRS global pairs (knobs on),
    then Trainer.evaluate on EVAL_BATCHES global batches: the logged
    records, the weights, the metrics and the files written."""
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig, Trainer,
                                                  TrainState, loop)
    model = knob_model(dtype)
    evaluated = []

    def gather(results):
        # the pairs that evaluate_results sees, every rank's
        out = allgather_results(results)
        evaluated.append(len(out["val_match_gt"]))
        return out
    allgather_results, loop.allgather_results = loop.allgather_results, gather
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    runtime = dict(work_dir=work_dir, seed=0, max_epochs=1, eval_interval=0,
                   checkpoint_interval=0, log_interval=1,
                   losses_to_use=FIT_USE, alpha=dict(kl=0.1, cls=0.5),
                   num_classes=20)
    trainer = Trainer(model, _Loader(steps, 1, np_dtype),
                      _Loader(EVAL_BATCHES, 2, np_dtype), runtime)
    state = TrainState.create(model, ScheduleConfig(**SCHED), steps)
    state = trainer.fit(state)
    try:
        metrics = trainer.evaluate(state)
    finally:
        loop.allgather_results = allgather_results
    records = []
    path = os.path.join(work_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            records = [json.loads(line) for line in f]
    return dict(weights=_weights(model), records=records, metrics=metrics,
                pairs=evaluated[0], files=sorted(os.listdir(work_dir)))


def fused_remat_steps(steps: int = 1) -> dict:
    """fused_train with every SA stage under remat_stages and the global
    remat on, in float64: logs and weights after `steps` steps."""
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig, TrainState,
                                                  make_train_step, to_device)
    from tests._torch_port import pair_batch
    model = knob_model(torch.float64, fused_train=True,
                       remat_stages=[0, 1, 2])
    state = TrainState.create(model, ScheduleConfig(**SCHED), 3)
    step = make_train_step(model, FIT_USE, dict(kl=0.1, cls=0.5),
                           remat=True)
    logs = []
    for i in range(steps):
        tb = {k: v.double() if v.is_floating_point() else v
              for k, v in to_device(_rows(pair_batch(40 + i, B=8)),
                                    "cpu").items()}
        _, log = step(state, tb, torch.Generator().manual_seed(9))
        logs.append({k: float(v) for k, v in log.items()})
    lr_spent = sum(state.optimizer.lr_fn(i) for i in range(steps))
    return dict(logs=logs, weights=_weights(model), lr_spent=lr_spent)


def gathered() -> dict:
    from point_cloud_reid_tpu_torch.parallel import allgather_results
    from point_cloud_reid_tpu_torch.parallel.distributed import process_index
    p = process_index()
    return allgather_results({
        "x": np.arange(6, dtype=np.float32).reshape(3, 2) + 100 * p,
        "y": np.full((2,), p)})


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    from point_cloud_reid_tpu_torch.parallel import (barrier, dp_step_check,
                                                     init_distributed)
    info = init_distributed(init_method="file://" + store, world_size=world,
                            rank=rank, device="cpu", timeout=TIMEOUT)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    out = dict(info=info, gathered=gathered())
    barrier("after-gather")
    out["tiny"] = tiny_step(inputs["neg"], steps=2)
    out["dp_check"] = dp_step_check(batch_per_device=2,
                                    device=torch.device("cpu"))
    out["fit"] = fit_and_eval(os.path.join(out_dir, "fit"))
    out["fit32"] = fit_and_eval(os.path.join(out_dir, "fit32"),
                                torch.float32, steps=1)
    out["fused"] = fused_remat_steps()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
