from .loop import (Trainer, make_eval_step, make_train_step, pin_batch,
                   to_device, train_forward)
from .losses import reid_losses
from .schedules import (ScheduleConfig, ScheduledAdamW, build_optimizer,
                        cyclic_schedule)
from .state import TrainState, param_count
from .synthetic import SyntheticPairLoader

__all__ = ["Trainer", "make_eval_step", "make_train_step", "pin_batch",
           "to_device", "train_forward", "reid_losses", "ScheduleConfig",
           "ScheduledAdamW",
           "build_optimizer", "cyclic_schedule", "TrainState", "param_count",
           "SyntheticPairLoader"]
