"""Training loop: train step + epoch loop + eval (port of train/loop.py).

  to_device, pin_batch  a loader's batch on the device; pinned in the
                        loader's worker thread for a CUDA run.
  make_train_step(...)  forward + losses + backward + optimizer update on
                        the model's device: (state, batch, generator) ->
                        (state, log_vars). remat=True recomputes each
                        stage's forward in the backward
                        (torch.utils.checkpoint).
  make_eval_step(...)   eval forward: per-pair tensors for the stratified
                        evaluator (evaluation/matching.py).
  Trainer               epoch loop: per-epoch loader reseed, interval eval,
                        checkpoints (torch.save / torch.load), metric
                        logging (utils/logging.py).

Data parallel: in a torch.distributed group (parallel.init_distributed,
one process a card under torchrun) the Trainer's step is one step over the
global batch, as the JAX step over a mesh: each process trains on its rows
(the loaders' shard), BatchNorm statistics, masked means, the triplet
negatives and the logged values are taken over the global batch
(parallel/distributed.py), and the ranks' gradients are summed in one
all-reduce a step. The initial state is broadcast from rank 0, rank 0
alone writes checkpoints and logs, and evaluation gathers every rank's
per-pair results.
A model built at a bf16 compute dtype (models.build_model(dtype=...))
trains as the JAX package's does: float32 parameters, gradients, AdamW
moments and accumulator, bf16 compute where flax casts.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..evaluation import evaluate_results
from ..models.attention_blocks import (CrossAttentionBlock, CrossLinAttn,
                                       LocalSelfAttention)
from ..models.dgcnn import EdgeConv
from ..models.layers import stage_contexts
from ..models.loftr import LoFTREncoderLayer
from ..models.point_transformer import (FeaturePropagationSA,
                                        SetAbstractionEdgeSA)
from ..models.pointnet import PointNetEncoder
from ..models.registry import SequentialHead
from ..models.vector_neurons import VNLinearLeakyReLU
from ..models.vit import Block
from ..parallel import allgather_results, barrier, replicated
from ..parallel import distributed as pdist
from ..parallel.distributed import (is_distributed, process_index,
                                    reduce_gradients, reduce_logs)
from ..utils.logging import MetricLogger
from .losses import reid_losses
from .schedules import global_norm
from .state import TrainState


def _host_tensor(v) -> torch.Tensor:
    t = torch.as_tensor(v)
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.long()
    return t


def _numpy(t: torch.Tensor):
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A loader's batch dict (numpy arrays or tensors) on `device`; integer
    arrays become int64. A pinned batch (pin_batch) is copied without
    blocking the host."""
    return {k: _host_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def pin_batch(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A loader's batch as pinned host tensors in to_device's dtypes: the
    BatchLoader transform of a run on CUDA, so that the pinning happens in
    the loader's worker thread and the upload does not wait on the host."""
    return {k: _host_tensor(v).pin_memory() for k, v in batch.items()}


# the stages whose forward remat recomputes one at a time. None holds
# another: a checkpoint inside a checkpointed stage makes torch's recompute
# save tensors in another order than the forward did, and the backward
# refuses it (seen with torch 2.13), so PointNet's transforms (STN) are
# recomputed with their encoder
_REMAT_STAGES = (SetAbstractionEdgeSA, FeaturePropagationSA,
                 PointNetEncoder, EdgeConv, VNLinearLeakyReLU,
                 CrossAttentionBlock, CrossLinAttn, LocalSelfAttention,
                 LoFTREncoderLayer, Block, SequentialHead)


@contextlib.contextmanager
def _checkpointed_stages(model) -> Iterator[None]:
    """Inside the block, each stage of `model` runs under non-reentrant
    torch.utils.checkpoint: it keeps its inputs and outputs, and the
    backward recomputes its forward when it reaches the stage, with the
    BatchNorm running statistics frozen (the forward moved them) and a
    data-parallel step's global statistics replayed
    (models.layers.stage_contexts). An SA stage that the backbone's
    remat_stages already checkpoints is left to it."""
    stages = [m for m in model.modules() if isinstance(m, _REMAT_STAGES)
              and not getattr(m, "remat", False)]
    for m in stages:
        m.forward = functools.partial(
            checkpoint, m.forward, use_reentrant=False,
            context_fn=functools.partial(stage_contexts, model))
    try:
        yield
    finally:
        for m in stages:
            del m.forward


def train_forward(model, batch: Dict[str, torch.Tensor], remat: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """The model's train-mode forward; with remat, each stage (SA, FP,
    cross and local stages, LoFTR layers, PointNet's encoder, DGCNN's
    EdgeConv blocks, VN-DGCNN's VN layers, heads, ViT blocks) under
    torch.utils.checkpoint
    (_checkpointed_stages), so that the backward holds one stage's
    activations at a time besides the stages' outputs."""
    if not remat:
        return model(batch, train=True)
    with _checkpointed_stages(model):
        return model(batch, train=True)


def make_train_step(model, losses_to_use: Dict[str, bool],
                    alpha: Dict[str, float], fp_label_threshold: int = 9,
                    use_o: bool = False, triplet_sample_num: int = 5,
                    triplet_margin: float = 0.2, monitor: bool = False,
                    remat: bool = False) -> Callable:
    """Build the train step: (state, batch, generator, neg_idx=None) ->
    (state, log_vars). `batch` is a dict of tensors on the model's device;
    `generator` draws the triplet negatives unless `neg_idx` supplies them.
    log_vars are 0-d tensors (no host sync); `grad_norm` is the global norm
    of this step's raw gradients.

    In a torch.distributed group the step is data parallel: `batch` is
    this process's rows of the global batch, and the step is the step over
    the global batch (the module docstring): every rank gets the same logs,
    `grad_norm` that of the global gradient, which is all-reduced once a
    step. With gradient accumulation the all-reduce comes once, at the
    update, of the accumulated gradient; the micro-steps' raw gradients
    are never reduced, so their logs carry no `grad_norm`. `generator`
    must stand in the same state on every rank; a given neg_idx is the
    global draw.

    remat=True is the JAX step's jax.checkpoint: the backward runs the
    forward again (train_forward), for less memory at the cost of a second
    forward. The recompute leaves the BatchNorm running statistics where
    the forward moved them (frozen_statistics), and the triplet negatives
    are drawn outside it, from `generator`."""
    need_dense = losses_to_use.get("dense", False)
    dp = is_distributed()

    def forward_backward(state: TrainState, batch, generator, neg_idx):
        out = train_forward(model, batch, remat)
        dense_feats = None
        if need_dense:
            # the dense branch is a target, not a path for gradients, and
            # must not touch the BatchNorm statistics
            with torch.no_grad():
                _, _, hd1, hd2 = model.siamese(batch["dense_1"],
                                               batch["dense_2"], train=False)
                dense_feats = torch.cat([hd1, hd2], dim=0)
        loss, log = reid_losses(
            out, batch, losses_to_use=losses_to_use, alpha=alpha,
            generator=generator, dense_feats=dense_feats,
            fp_label_threshold=fp_label_threshold, use_o=use_o,
            triplet_sample_num=triplet_sample_num,
            triplet_margin=triplet_margin, pool_type=model.pool_type,
            neg_idx=neg_idx)
        state.optimizer.zero_grad()
        loss.backward()
        return {k: v.detach() for k, v in log.items()}

    def train_step(state: TrainState, batch, generator=None, neg_idx=None):
        opt = state.optimizer
        if not dp:
            log = forward_backward(state, batch, generator, neg_idx)
            log["grad_norm"] = global_norm(opt.gradients())
            reduce = None
        else:
            # the backward recomputes checkpointed stages: it replays
            # their statistics inside the same block
            with pdist.data_parallel():
                log = reduce_logs(forward_backward(state, batch, generator,
                                                   neg_idx))
            reduce = reduce_gradients
            if opt.cfg.cumulative_iters == 1:
                grads = opt.gradients()
                reduce_gradients(grads)
                for p, g in zip(opt.params, grads):
                    p.grad = g
                log["grad_norm"] = global_norm(grads)
                reduce = None
        before = ([p.detach().clone() for p in opt.params] if monitor
                  else None)
        opt.step(reduce=reduce)
        if monitor:
            log["param_norm"] = global_norm([p.detach() for p in opt.params])
            log["update_norm"] = global_norm(
                [p.detach() - b for p, b in zip(opt.params, before)])
        state.step += 1
        return state, log

    return train_step


def make_eval_step(model, losses_to_use: Dict[str, bool],
                   alpha: Dict[str, float], fp_label_threshold: int = 9
                   ) -> Callable:
    """Eval forward: (state, batch, generator) -> per-pair tensors for the
    host-side stratified evaluator. In a torch.distributed group `batch` is
    this process's rows, and each val_*_loss is the global batch's (the
    same on every rank), as in the JAX eval step over a mesh."""
    data_parallel = is_distributed()

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator=None):
        out = model(batch, train=False)
        with (pdist.data_parallel() if data_parallel
              else contextlib.nullcontext()):
            _, log = reid_losses(out, batch, losses_to_use=losses_to_use,
                                 alpha=alpha, generator=generator,
                                 fp_label_threshold=fp_label_threshold,
                                 pool_type=model.pool_type)
        if data_parallel:
            log = reduce_logs({k: v for k, v in log.items()
                               if k.endswith("_loss")})
        labels_cat = torch.cat([batch["label_1"], batch["label_2"]], 0)
        res = dict(
            val_match_preds=out["match_logits"],
            val_match_gt=out["match"],
            match_classes=torch.stack([batch["label_1"], batch["label_2"]],
                                      1),
            val_cls_gt=labels_cat,
            val_fp_gt=(labels_cat > fp_label_threshold).float(),
            is_fp=(batch["label_1"] > fp_label_threshold)
            | (batch["label_2"] > fp_label_threshold),
        )
        if "cls_logits" in out:
            res["val_cls_preds"] = out["cls_logits"]
        if "fp_logits" in out:
            res["val_fp_preds"] = out["fp_logits"]
        if "size_1" in batch:
            res["num_points"] = torch.stack([batch["size_1"],
                                             batch["size_2"]], 1)
        if "vis_1" in batch:
            res["val_vis_gt_all"] = torch.stack([batch["vis_1"],
                                                 batch["vis_2"]], 1)
        if "dist_1" in batch:
            res["distances"] = torch.stack([batch["dist_1"],
                                            batch["dist_2"]], 1)
        for k, v in log.items():
            if k.endswith("_loss"):
                res["val_" + k] = v[None]
        return res

    return eval_step


class Trainer:
    """Epoch loop over the train and eval steps.

    Args:
        model: ReIDNet (models.build_model), on the device it trains on.
        train_loader / val_loader: iterables of batch dicts with __len__
            and set_epoch (data.BatchLoader, train/synthetic.py).
        cfg: runtime dict: max_epochs, eval_interval, checkpoint_interval,
            max_keep_ckpts, save_last, save_best, log_interval, work_dir,
            seed, losses_to_use, alpha, cls_to_idx, num_classes,
            fp_label_threshold, use_o, triplet_sample_num, triplet_margin,
            monitor, remat.

    In a torch.distributed group the Trainer trains data parallel (the
    module docstring): the loaders are this process's shards of the
    global batches (data.BatchLoader's shard_id / num_shards), and on
    every rank but 0 the logger is silent and nothing is written.
    """

    def __init__(self, model, train_loader, val_loader, cfg: Dict[str, Any],
                 logger: Optional[MetricLogger] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.cfg = cfg
        self.distributed = is_distributed()
        self.writer = process_index() == 0
        if not self.writer:
            logger = MetricLogger(None, quiet=True)
        self.logger = logger or MetricLogger(cfg.get("work_dir"))
        lcfg = cfg.get("losses_to_use", dict(match=True))
        alpha = cfg.get("alpha", {})
        fp_thr = cfg.get("fp_label_threshold", 9)
        self.train_step = make_train_step(
            model, lcfg, alpha, fp_label_threshold=fp_thr,
            use_o=cfg.get("use_o", False),
            triplet_sample_num=cfg.get("triplet_sample_num", 5),
            triplet_margin=cfg.get("triplet_margin", 0.2),
            monitor=cfg.get("monitor", False),
            remat=cfg.get("remat", False))
        self.eval_step = make_eval_step(
            model, dict(lcfg, triplet=False, dense=False), alpha,
            fp_label_threshold=fp_thr)
        self._kept_epochs: list = []

    # ---- checkpoints ---------------------------------------------------------

    def save_checkpoint(self, state: TrainState, tag: str = "last"):
        """Write {work_dir}/ckpt_{tag}.pt: model, optimizer and step. In a
        group rank 0 writes it, and every rank waits until it has."""
        work_dir = self.cfg.get("work_dir")
        if not work_dir:
            return None
        path = os.path.join(work_dir, f"ckpt_{tag}.pt")
        if self.writer:
            os.makedirs(work_dir, exist_ok=True)
            torch.save(state.state_dict(), path + ".tmp")
            os.replace(path + ".tmp", path)
        barrier("checkpoint")
        return path

    def _save_interval_checkpoint(self, state: TrainState, epoch: int):
        """Retention policy of the reference's checkpoint_config:
        interval-tagged ckpt_epoch_{N} saves with only the newest
        max_keep_ckpts kept, plus an always-current ckpt_last."""
        work_dir = self.cfg.get("work_dir")
        if not work_dir:
            return
        self.save_checkpoint(state, tag=f"epoch_{epoch}")
        self._kept_epochs.append(epoch)
        max_keep = self.cfg.get("max_keep_ckpts", 1)
        if max_keep and max_keep > 0:
            while len(self._kept_epochs) > max_keep:
                old = self._kept_epochs.pop(0)
                path = os.path.join(work_dir, f"ckpt_epoch_{old}.pt")
                if self.writer and os.path.exists(path):
                    os.remove(path)
        if self.cfg.get("save_last", True):
            self.save_checkpoint(state, tag="last")

    def _read(self, path: str) -> Dict[str, Any]:
        # a checkpoint holds tensors, numbers and containers only
        return torch.load(path, map_location=self.device, weights_only=True)

    def load_checkpoint(self, state: TrainState, path: str) -> TrainState:
        """Full-state restore: params + batch stats + optimizer + step
        (resume semantics)."""
        state.load_state_dict(self._read(path))
        return state

    def load_weights(self, state: TrainState, path: str) -> TrainState:
        """Weights-only restore: params + batch stats from a checkpoint (its
        'model' entry) or a bare model state_dict; the optimizer and the
        step stay as they are in `state` (fine-tuning must not resume the
        old LR position or Adam moments)."""
        saved = self._read(path)
        if isinstance(saved.get("model"), dict):
            saved = saved["model"]
        state.model.load_state_dict(saved)
        return state

    # ---- loops ---------------------------------------------------------------

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.get("seed", 0))

    def fit(self, state: TrainState, max_epochs: Optional[int] = None
            ) -> TrainState:
        max_epochs = max_epochs or self.cfg.get("max_epochs", 1)
        eval_interval = self.cfg.get("eval_interval", 0)
        ckpt_interval = self.cfg.get("checkpoint_interval", 0)
        log_interval = self.cfg.get("log_interval", 50)
        generator = self._generator()
        self._kept_epochs = []
        best_acc = float("-inf")
        replicated(state.model, state.optimizer)

        def host(log):
            return {k: float(v) for k, v in log.items()}

        for epoch in range(max_epochs):
            self.train_loader.set_epoch(epoch)
            t0 = time.time()
            n, log = 0, {}
            for batch in self.train_loader:
                state, log = self.train_step(
                    state, to_device(batch, self.device), generator)
                n += 1
                if n % log_interval == 0:
                    self.logger.log_train(state.step, epoch, host(log))
            self.logger.log_train(state.step, epoch, host(log),
                                  extra={"epoch_time_s": time.time() - t0})

            interval = eval_interval
            if isinstance(eval_interval, (list, tuple)):
                # dynamic intervals: [(start_epoch, interval), ...]
                interval = 0
                for start, iv in eval_interval:
                    if epoch + 1 >= start:
                        interval = iv
            if interval and (epoch + 1) % interval == 0:
                metrics = self.evaluate(state)
                self.logger.log_eval(state.step, epoch, metrics)
                acc = metrics.get("val_match_acc")
                if (self.cfg.get("save_best", True) and acc is not None
                        and acc > best_acc):
                    best_acc = acc
                    self.save_checkpoint(state, tag="best")
            if ckpt_interval and (epoch + 1) % ckpt_interval == 0:
                self._save_interval_checkpoint(state, epoch + 1)
        self.save_checkpoint(state, tag="final")
        return state

    def evaluate(self, state: TrainState) -> Dict[str, Any]:
        """Eval forward over the val loader, host-side aggregation; writes
        {work_dir}/eval_results.json. In a group each rank evaluates its
        shard of the val batches and every rank aggregates the per-pair
        results of all (allgather_results); rank 0 writes the file."""
        generator = self._generator()
        accum: Dict[str, list] = {}
        for batch in self.val_loader:
            res = self.eval_step(state, to_device(batch, self.device),
                                 generator)
            for k, v in res.items():
                accum.setdefault(k, []).append(v)
        # numpy has no bf16: a bf16 model's logits go to the host in
        # float32, which holds each bf16 value exactly
        results = allgather_results(
            {k: _numpy(torch.cat(v, dim=0)) for k, v in accum.items()})
        metrics = evaluate_results(
            results, cls_to_idx=self.cfg.get("cls_to_idx", {}),
            num_classes=self.cfg.get("num_classes", 10))
        work_dir = self.cfg.get("work_dir")
        if work_dir and self.writer:
            with open(os.path.join(work_dir, "eval_results.json"), "w") as f:
                json.dump(metrics, f, indent=1)
        return metrics
