"""Track motion models: constant velocity and a learned LSTM incrementor
(port of tracking/motion.py).

constant_velocity_step propagates a box by its BEV velocity;
LSTMIncrementor runs an LSTM over a track's observation history and maps
the last valid output to a BEV displacement; BoxUpdater refines a track's
box after association.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def constant_velocity_step(box: torch.Tensor, velocity: torch.Tensor,
                           dt: float = 1.0) -> torch.Tensor:
    """(7,) box + (2,) BEV velocity -> the box moved by velocity * dt."""
    return torch.cat([box[:2] + velocity * dt, box[2:]])


class LSTMIncrementor(nn.Module):
    """Learned displacement model over a track's observation sequence.

    forward(seq (B, T, in_features), lengths (B,) or None) -> (B, 2): the
    head applied to each row's output at step lengths - 1 (clipped to
    [0, T - 1]), or at the last step without lengths. The LSTM starts from
    zeros; its gates are the flax OptimizedLSTMCell's (i, f, g, o, no
    peepholes), so convert.from_jax_variables carries JAX weights over."""

    def __init__(self, in_features: int, hidden: int = 64):
        super().__init__()
        self.hidden = hidden
        self.lstm = nn.LSTM(in_features, hidden, batch_first=True)
        self.head = nn.Linear(hidden, 2)

    def forward(self, seq: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        ys, _ = self.lstm(seq)                                 # (B, T, H)
        if lengths is not None:
            idx = torch.clamp(lengths.long() - 1, 0, seq.shape[1] - 1)
            last = ys[torch.arange(seq.shape[0], device=seq.device), idx]
        else:
            last = ys[:, -1]
        return self.head(last)


class BoxUpdater:
    """Post-association box refinement: the centre from the detection,
    dims and yaw smoothed exponentially (yaw along the shorter arc)."""

    def __init__(self, dim_momentum: float = 0.7, yaw_momentum: float = 0.7):
        self.dim_momentum = dim_momentum
        self.yaw_momentum = yaw_momentum

    def __call__(self, track_box: torch.Tensor, det_box: torch.Tensor
                 ) -> torch.Tensor:
        dims = (self.dim_momentum * track_box[3:6]
                + (1 - self.dim_momentum) * det_box[3:6])
        diff = det_box[6] - track_box[6]
        dyaw = torch.atan2(torch.sin(diff), torch.cos(diff))
        yaw = track_box[6] + (1 - self.yaw_momentum) * dyaw
        return torch.cat([det_box[:3], dims, yaw[None]])
