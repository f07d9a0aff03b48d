"""Hand-written CUDA kernels of the port and their plain versions.

  sa_stage.fused_sa_convmax          <- ops/pallas/sa_stage.py::fused_sa_convmax
  match_grid.fused_match_grid        <- ops/pallas/match_grid.py::fused_match_grid
  match_grid.fused_match_pairs       <- ops/pallas/match_grid.py::fused_match_pairs
  match_grid.fused_image_match_grid  <- the same with with_pos=False
                                        (pallas_image_grid_logits)
  match_grid.fused_image_match_pairs <- the same (pallas_image_pair_logits)
  linear_attention.fused_linear_attention
                                     <- ops/pallas/linear_attention.py
  knn.knn                            <- ops/pallas/knn.py::knn_pallas
  fps.fps                            <- ops/pallas/fps.py::fps_pallas

The CUDA sources live in ../csrc and are built at first use (_lib.py).
"""
