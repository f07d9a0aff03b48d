from .experiments import (EXPERIMENTS, apply_overrides, compose,
                          get_experiment, runtime, schedule)
from .models import point_transformer_point_cat

__all__ = ["EXPERIMENTS", "apply_overrides", "compose", "get_experiment",
           "runtime", "schedule", "point_transformer_point_cat"]
