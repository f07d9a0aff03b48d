"""Train state: the model, its optimizer and the step count.

Replaces the JAX package's immutable TrainState pytree: the model (params
and BatchNorm running statistics) and the optimizer are updated in place by
the train step; the state object groups them for the Trainer and the
checkpoints. As in the JAX package, the parameters and the optimizer state
(AdamW moments, the accumulated gradient) are in the parameters' dtype,
float32, whatever the model's compute dtype: a model built with
dtype=torch.bfloat16 casts its float32 weights where it computes, and
their gradients come back float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .schedules import ScheduleConfig, ScheduledAdamW, build_optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: ScheduledAdamW
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, schedule: ScheduleConfig,
               steps_per_epoch: int) -> "TrainState":
        """Make every parameter of `model` trainable (build_model returns a
        frozen eval model) and build its optimizer."""
        model.requires_grad_(True)
        return cls(model, build_optimizer(model.parameters(), schedule,
                                          steps_per_epoch))

    def state_dict(self) -> Dict[str, Any]:
        return dict(model=self.model.state_dict(),
                    optimizer=self.optimizer.state_dict(), step=self.step)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = state["step"]


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
