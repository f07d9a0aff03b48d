"""Tracking supervision losses on tensors (port of tracking/supervision.py).

Losses over a (T, D) association cost or logit matrix given the ground-truth
matching (focal, margin ranking, row softmax with a no-match bucket), and
the BEV metric supervision: features sampled at object centres, a per-track
triplet loss over a scene's samples and the per-class scene memory. All are
differentiable by autograd.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy, elementwise."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0,
                       weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Sigmoid focal loss, mean-reduced; alpha < 0 turns the class
    balance off."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    if weight is not None:
        loss = loss * weight
    return loss.mean()


def association_margin_loss(cost: torch.Tensor, gt_matches: torch.Tensor,
                            margin: float = 0.2,
                            valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Margin ranking over cost-matrix rows: for every track t with a
    ground-truth detection g(t), every other admissible detection must cost
    at least `margin` more,
        loss = mean relu(cost[t, g(t)] + margin - cost[t, d]),  d != g(t).

    cost (T, D), lower is better; gt_matches (T,) det index or -1; valid
    optional (T, D) mask of admissible pairs."""
    T, D = cost.shape
    gt_matches = gt_matches.long()
    has_gt = gt_matches >= 0
    gt_idx = torch.clamp(gt_matches, 0, D - 1)
    gt_cost = torch.gather(cost, 1, gt_idx[:, None])              # (T, 1)
    viol = F.relu(gt_cost + margin - cost)                        # (T, D)
    not_gt = (torch.arange(D, device=cost.device)[None, :]
              != gt_idx[:, None])
    mask = not_gt & has_gt[:, None]
    if valid is not None:
        mask = mask & valid
    denom = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, viol, torch.zeros_like(viol)).sum() / denom


def softmax_association_loss(logits: torch.Tensor, gt_matches: torch.Tensor,
                             valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Row-softmax cross-entropy over D detections plus a 'no match'
    bucket of logit 0; a track without a match supervises the bucket.

    logits (T, D), higher is better; gt_matches (T,) det index or -1."""
    T, D = logits.shape
    full = torch.cat([logits, logits.new_zeros((T, 1))], dim=1)
    if valid is not None:
        ok = torch.cat([valid, torch.ones((T, 1), dtype=torch.bool,
                                          device=valid.device)], dim=1)
        full = torch.where(ok, full, torch.full_like(full, -float("inf")))
    gt_matches = gt_matches.long()
    labels = torch.where(gt_matches >= 0, gt_matches,
                         torch.full_like(gt_matches, D))
    logp = torch.log_softmax(full, dim=1)
    return -torch.gather(logp, 1, labels[:, None]).mean()


# ---- BEV metric supervision --------------------------------------------------


def sample_bev_features(bev: torch.Tensor, centers_xy: torch.Tensor,
                        point_cloud_range,
                        generator: Optional[torch.Generator] = None,
                        jitter: float = 0.5) -> torch.Tensor:
    """BEV features at object centres, jittered by jitter * N(0, 1) drawn
    from `generator` when one is given.

    bev (H, W, C); centers_xy (M, 2) lidar frame. Returns (M, C). The
    sampling normalises positions to grid_sample's [-1, 1]
    (ops/bev_feat.interpolate_bev)."""
    from ..ops.bev_feat import interpolate_bev
    if generator is not None and jitter > 0:
        centers_xy = centers_xy + jitter * torch.randn(
            centers_xy.shape, generator=generator, dtype=centers_xy.dtype,
            device=centers_xy.device)
    return interpolate_bev(bev, centers_xy, point_cloud_range)


def bev_triplet_metric_loss(feats: torch.Tensor, track_ids: torch.Tensor,
                            num_tracks: int, margin: float = 1.0
                            ) -> torch.Tensor:
    """Per-track triplet metric loss over a scene's features.

    For every anchor of a track the positives are the track's other samples
    and the negatives every sample of the other tracks (the full masked
    triplet set); each track's mean hinge, summed over tracks. Distances
    are torch.pairwise_distance's, L2 of (a - b + 1e-6).

    feats (M, C); track_ids (M,) in [-1, num_tracks), -1 for padding."""
    m = feats.shape[0]
    track_ids = track_ids.long()
    valid = track_ids >= 0
    diff = feats[:, None, :] - feats[None, :, :] + 1e-6
    dist = torch.sqrt((diff * diff).sum(-1))                      # (M, M)
    both = valid[:, None] & valid[None, :]
    same = (track_ids[:, None] == track_ids[None, :]) & both
    eye = torch.eye(m, dtype=torch.bool, device=feats.device)
    pos_mask = same & ~eye
    neg_mask = (~same) & both
    hinge = F.relu(dist[:, :, None] - dist[:, None, :] + margin)
    tmask = (pos_mask[:, :, None] & neg_mask[:, None, :]).to(feats.dtype)
    per_anchor_sum = (hinge * tmask).sum(dim=(1, 2))              # (M,)
    per_anchor_cnt = tmask.sum(dim=(1, 2))
    ids = torch.clamp(track_ids, 0, num_tracks - 1)
    tl = feats.new_zeros((num_tracks,)).index_add(0, ids, per_anchor_sum)
    tc = feats.new_zeros((num_tracks,)).index_add(0, ids, per_anchor_cnt)
    return (tl / torch.clamp(tc, min=1.0)).sum()


class BEVMemory:
    """Per-class scene memory for the BEV metric supervision: append
    (features, track ids) every frame, take the metric loss at scene end."""

    def __init__(self):
        self._feats = {}
        self._ids = {}

    def reset(self):
        self._feats.clear()
        self._ids.clear()

    def append(self, cls_idx: int, feats: torch.Tensor, track_ids):
        self._feats.setdefault(cls_idx, []).append(feats)
        self._ids.setdefault(cls_idx, []).append(track_ids)

    def metric_loss(self, margin: float = 1.0) -> torch.Tensor:
        """Sum over classes of the per-track triplet loss of the scene."""
        total = torch.zeros(())
        for cls_idx, feats in self._feats.items():
            feats = torch.cat([torch.as_tensor(f) for f in feats], dim=0)
            raw = np.concatenate([
                i.cpu().numpy() if isinstance(i, torch.Tensor)
                else np.asarray(i) for i in self._ids[cls_idx]])
            uniq = np.unique(raw[raw >= 0])
            lookup = {int(v): i for i, v in enumerate(uniq)}
            dense = np.array([lookup.get(int(v), -1) for v in raw], np.int64)
            total = total.to(feats.device) + bev_triplet_metric_loss(
                feats, torch.from_numpy(dense).to(feats.device),
                num_tracks=max(len(uniq), 1), margin=margin)
        return total
