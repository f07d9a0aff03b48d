"""3D multi-object tracking on ReID cost matrices (port of tracking/).

association.py, track.py and decisions.py are copies of the JAX package's
numpy-only modules (its tracking/__init__.py imports jax, so they cannot be
imported from there).
"""
from .association import associate, center_distance_gate, greedy_assignment
from .crops import extract_box_crops
from .decisions import DecisionModifier, sampling_rate
from .image_crops import crops_per_frame, extract_crops, project_boxes
from .manager import SWEEP_SIZES, TrackingManager
from .motion import BoxUpdater, LSTMIncrementor, constant_velocity_step
from .supervision import (association_margin_loss, sigmoid_focal_loss,
                          softmax_association_loss)
from .track import Track, TrackStore

__all__ = [
    "associate", "center_distance_gate", "greedy_assignment",
    "extract_box_crops", "crops_per_frame", "extract_crops", "project_boxes",
    "SWEEP_SIZES", "TrackingManager", "Track", "TrackStore",
    "DecisionModifier", "sampling_rate", "BoxUpdater", "LSTMIncrementor",
    "constant_velocity_step",
    "sigmoid_focal_loss", "association_margin_loss",
    "softmax_association_loss",
]
