from .experiments import (EXPERIMENTS, apply_overrides, compose,
                          get_experiment, runtime, schedule)
from .models import (dgcnn_point_cat, image_deit_point_cat,
                     point_transformer_baseline, point_transformer_point_cat,
                     point_transformer_scaled, pointnet_point_cat)

__all__ = ["EXPERIMENTS", "apply_overrides", "compose", "get_experiment",
           "runtime", "schedule", "dgcnn_point_cat", "image_deit_point_cat",
           "point_transformer_baseline", "point_transformer_point_cat",
           "point_transformer_scaled", "pointnet_point_cat"]
