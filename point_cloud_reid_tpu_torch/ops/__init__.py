from .attention import elu_feature_map, linear_attention
from .boxes import box_corners_3d, points_in_rboxes
from .geometry import (conv1_edge_factors, farthest_point_sample,
                       index_points, knn_indices,
                       random_point_sample, sample_and_group_edge,
                       square_distance)

__all__ = [
    "elu_feature_map", "linear_attention", "box_corners_3d",
    "points_in_rboxes", "conv1_edge_factors", "farthest_point_sample",
    "index_points", "knn_indices",
    "random_point_sample", "sample_and_group_edge", "square_distance",
]
