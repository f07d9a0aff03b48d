from .attention import elu_feature_map, full_attention, linear_attention
from .bev_feat import grid_sample_bilinear, interpolate_bev
from .boxes import (box_corners_3d, boxes_iou_3d, boxes_iou_bev,
                    boxes_overlap_bev, nms_bev, points_in_rboxes,
                    points_to_box_frame)
from .geometry import (conv1_edge_factors, edge_features,
                       farthest_point_sample, get_graph_feature,
                       index_points, knn_feature_space, knn_indices,
                       random_point_sample, sample_and_group_edge,
                       square_distance)

__all__ = [
    "elu_feature_map", "full_attention", "linear_attention",
    "grid_sample_bilinear",
    "interpolate_bev", "box_corners_3d", "boxes_iou_3d", "boxes_iou_bev",
    "boxes_overlap_bev", "nms_bev", "points_in_rboxes", "points_to_box_frame",
    "conv1_edge_factors", "edge_features", "farthest_point_sample",
    "get_graph_feature", "index_points", "knn_feature_space", "knn_indices", "random_point_sample", "sample_and_group_edge",
    "square_distance",
]
