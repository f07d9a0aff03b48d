"""Point-cloud op library of the port, the counterpart of
point_cloud_reid_tpu/ops (the reference's native extensions):

  furthest_point_sample -> geometry.farthest_point_sample(_with_dist)
                           [kernels.fps on CUDA tensors]
  knn                   -> geometry.knn_indices / knn_feature_space
                           [kernels.knn with knn_method='pallas']
  ball_query            -> geometry.query_ball_point
  group_points          -> geometry.group_points / index_points
  gather_points         -> geometry.index_points
  interpolate           -> geometry.three_nn / three_interpolate /
                           interpolate_idw
  voxel                 -> voxel.voxelize_hard / dynamic_scatter_mean
  bev_pool              -> voxel.bev_pool
  iou3d                 -> boxes.boxes_iou_bev / boxes_iou_3d / nms_bev
  roiaware_pool3d       -> boxes.points_in_rboxes
  paconv                -> sparse.assign_score_withk
  spconv                -> sparse.{build_indice_pairs, submanifold_conv3d,
                           sparse_conv3d, sparse_inverse_conv3d,
                           sparse_maxpool3d, to_dense}
  box structures        -> boxes3d.Boxes3D
  BEV feature sampling  -> bev_feat.interpolate_bev(_grid) / get_pixel_feat /
                           get_roi_feat

`__all__` is the JAX package's; the SA stage's conv1_edge_factors and
DGCNN's edge_features are importable beside it, as there.
"""
from .attention import elu_feature_map, full_attention, linear_attention
from .bev_feat import (centered_grid, get_pixel_feat, get_roi_feat,
                       grid_sample_bilinear, interpolate_bev,
                       interpolate_bev_grid, linear_interp)
from .boxes import (box_corners_3d, box_corners_bev, boxes_iou_3d,
                    boxes_iou_bev, boxes_overlap_bev, nms_bev,
                    points_in_rboxes, points_to_box_frame, rotation_2d)
from .boxes3d import Boxes3D
from .geometry import (chamfer_distance, conv1_edge_factors, edge_features,
                       farthest_point_sample,
                       farthest_point_sample_with_dist, get_graph_feature,
                       group_points, index_points, interpolate_idw,
                       knn_feature_space, knn_indices, query_ball_point,
                       random_point_sample, sample_and_group_all,
                       sample_and_group_edge, square_distance, subsample_pc,
                       three_interpolate, three_nn)
from .sparse import (assign_score_withk, build_indice_pairs,
                     build_strided_output, sparse_conv3d,
                     sparse_inverse_conv3d, sparse_maxpool3d,
                     submanifold_conv3d, to_dense)
from .voxel import bev_pool, dynamic_scatter_mean, voxelize_hard

__all__ = [
    "elu_feature_map", "full_attention", "linear_attention",
    "centered_grid", "get_pixel_feat", "get_roi_feat", "grid_sample_bilinear",
    "interpolate_bev", "interpolate_bev_grid", "linear_interp",
    "box_corners_3d", "box_corners_bev", "boxes_iou_3d", "boxes_iou_bev",
    "boxes_overlap_bev", "nms_bev", "points_in_rboxes", "points_to_box_frame",
    "rotation_2d",
    "chamfer_distance", "farthest_point_sample",
    "farthest_point_sample_with_dist", "get_graph_feature", "group_points",
    "index_points", "interpolate_idw", "knn_feature_space", "knn_indices",
    "query_ball_point", "random_point_sample", "sample_and_group_all",
    "sample_and_group_edge", "square_distance", "subsample_pc",
    "three_interpolate", "three_nn",
    "bev_pool", "dynamic_scatter_mean", "voxelize_hard",
    "Boxes3D", "assign_score_withk", "build_indice_pairs",
    "build_strided_output", "sparse_conv3d", "sparse_inverse_conv3d",
    "sparse_maxpool3d", "submanifold_conv3d", "to_dense",
]
