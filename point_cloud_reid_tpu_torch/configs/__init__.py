from .experiments import (EXPERIMENTS, apply_overrides, compose,
                          get_experiment, runtime, schedule)
from .models import (image_deit_point_cat, point_transformer_point_cat,
                     point_transformer_scaled)

__all__ = ["EXPERIMENTS", "apply_overrides", "compose", "get_experiment",
           "runtime", "schedule", "image_deit_point_cat",
           "point_transformer_point_cat", "point_transformer_scaled"]
