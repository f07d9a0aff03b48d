"""Optimizer + LR / momentum schedule (port of train/schedules.py).

The reference's schedule axis: AdamW + mmcv one-cycle "cyclic" LR and
momentum + global-norm gradient clipping + optional gradient accumulation:

  optimizer = AdamW(lr, weight_decay=0.01), eps 1e-8 outside the root,
      decay on every parameter
  lr: cos-anneal lr -> 10 lr over the first 40% of steps, then -> 1e-4 lr
  momentum (beta1): 0.95 -> 0.85 -> 0.95 on the same phases
  grad_clip: global norm 35 (or 1 for *_norm1 configs), scaled by
      max_norm / max(norm, max_norm)
  accumulation: the mean of `cumulative_iters` gradients, one update every
      `cumulative_iters` steps

`ScheduledAdamW` holds a torch.optim.AdamW and sets its lr and betas[0]
before every update from the number of updates made so far, which is where
the JAX package's optimizer reads its schedules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch


@dataclasses.dataclass
class ScheduleConfig:
    """One row of the reference schedule grid (configs name them
    cyclic_{E}e_lr{LR}[_norm1][_accumN])."""

    policy: str = "cyclic"                 # 'cyclic' | 'cosine' | 'fixed'
    lr: float = 3e-4
    weight_decay: float = 0.01
    max_epochs: int = 500
    grad_clip_norm: Optional[float] = 35.0
    cumulative_iters: int = 1
    # cyclic params (mmcv CyclicLrUpdaterHook defaults used by the configs)
    target_ratio: Tuple[float, float] = (10.0, 1e-4)
    step_ratio_up: float = 0.4
    momentum_base: float = 0.95
    momentum_ratio: Tuple[float, float] = (0.85 / 0.95, 1.0)


def _cos_anneal(start: float, end: float, pct: float) -> float:
    return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2


def cyclic_schedule(base: float, total_steps: int,
                    target_ratio: Tuple[float, float] = (10.0, 1e-4),
                    step_ratio_up: float = 0.4) -> Callable[[int], float]:
    """mmcv one-cycle with cosine annealing within each phase: step ->
    value, constant from the last step on."""
    up = max(1, int(total_steps * step_ratio_up))
    hi = base * target_ratio[0]
    lo = base * target_ratio[1]

    def fn(step: int) -> float:
        step = min(step, total_steps - 1)
        if step < up:
            return _cos_anneal(base, hi, min(max(step / up, 0.0), 1.0))
        pct = (step - up) / max(total_steps - up, 1)
        return _cos_anneal(hi, lo, min(max(pct, 0.0), 1.0))

    return fn


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


class ScheduledAdamW:
    """AdamW with scheduled lr + beta1, clip-by-global-norm and gradient
    accumulation. `step()` consumes the parameters' .grad and clears it."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: ScheduleConfig, steps_per_epoch: int):
        self.cfg = cfg
        self.params = [p for p in params if p.requires_grad]
        total = max(1, cfg.max_epochs * steps_per_epoch)
        if cfg.policy == "cyclic":
            self.lr_fn = cyclic_schedule(cfg.lr, total, cfg.target_ratio,
                                         cfg.step_ratio_up)
            self.b1_fn = cyclic_schedule(cfg.momentum_base, total,
                                         cfg.momentum_ratio,
                                         cfg.step_ratio_up)
        elif cfg.policy == "cosine":
            self.lr_fn = lambda s: cfg.lr * 0.5 * (
                1 + math.cos(math.pi * min(s, total) / total))
            self.b1_fn = lambda s: 0.9
        else:
            self.lr_fn = lambda s: cfg.lr
            self.b1_fn = lambda s: 0.9
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.updates = 0          # optimizer updates made (schedule index)
        self.mini_step = 0        # gradients accumulated toward the next
        self._acc = None

    def gradients(self):
        """This step's gradient of every trainable parameter (zeros where
        a parameter took no part in the loss)."""
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def step(self, reduce: Optional[Callable[[List[torch.Tensor]], None]]
             = None) -> bool:
        """One training step's gradients. Returns True if the parameters
        were updated (every `cumulative_iters`-th call). `reduce` (in
        place, on a list of gradients) runs once on the gradient an update
        applies: a data-parallel step's all-reduce of the accumulated
        gradient."""
        grads = self.gradients()
        k = self.cfg.cumulative_iters
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # running mean of the k gradients
            torch._foreach_sub_(grads, self._acc)
            torch._foreach_add_(self._acc, grads,
                                alpha=1.0 / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < k:
                self.zero_grad()
                return False
            grads, self._acc, self.mini_step = self._acc, None, 0
        if reduce is not None:
            reduce(grads)
        clip = self.cfg.grad_clip_norm
        if clip is not None:
            norm = global_norm(grads)
            torch._foreach_mul_(grads, clip / norm.clamp(min=clip))
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_fn(self.updates)
            group["betas"] = (self.b1_fn(self.updates), group["betas"][1])
        self.adamw.step()
        self.updates += 1
        self.zero_grad()
        return True

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict[str, Any]:
        return dict(adamw=self.adamw.state_dict(), updates=self.updates,
                    mini_step=self.mini_step, acc=self._acc)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.updates = state["updates"]
        self.mini_step = state["mini_step"]
        self._acc = state["acc"]


def build_optimizer(params: Iterable[torch.nn.Parameter], cfg: ScheduleConfig,
                    steps_per_epoch: int) -> ScheduledAdamW:
    return ScheduledAdamW(params, cfg, steps_per_epoch)
