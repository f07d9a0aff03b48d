"""Teacher-forcing decision modification for tracker training.

Equivalent of TrackingDecisionModifier
(trackers/deprecated/tracking_decision_modifier.py:13-120): during
tracker-in-the-loop training, each decision type (newborn detection,
false-positive suppression, det/track matching) is replaced by the
ground-truth decision with a probability that decays over epochs — pure
teacher forcing early, pure model decisions late.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DECISION_TYPES = ("det_newborn", "det_false_positive", "det_match",
                  "trk_match")


def sampling_rate(mode: str, epoch: int, max_epoch: int) -> float:
    """Probability of using the ground-truth decision.

    Modes mirror the reference's decision_sampling schedules:
    'linear_decay' 1 -> 0 over training; 'always' pure teacher forcing;
    'never' pure model decisions.
    """
    if mode == "always":
        return 1.0
    if mode == "never":
        return 0.0
    if mode == "linear_decay":
        return max(0.0, 1.0 - epoch / max(max_epoch, 1))
    if mode == "cosine_decay":
        return float(0.5 * (1 + np.cos(np.pi * min(epoch / max(max_epoch, 1),
                                                   1.0))))
    raise ValueError(f"unknown decision sampling mode {mode}")


class DecisionModifier:
    """Mixes predicted association decisions with ground truth per type."""

    def __init__(self, decision_sampling: Dict[str, str] | None = None,
                 seed: int = 0):
        self.decision_sampling = decision_sampling or {
            t: "linear_decay" for t in DECISION_TYPES}
        self.epoch = 0
        self.max_epoch = 1
        self.rng = np.random.RandomState(seed)

    def set_epoch(self, epoch: int, max_epoch: int):
        """(TrackingDecisionModifier.set_epoch :31-33)"""
        self.epoch = epoch
        self.max_epoch = max_epoch

    def rate(self, decision_type: str) -> float:
        return sampling_rate(
            self.decision_sampling.get(decision_type, "linear_decay"),
            self.epoch, self.max_epoch)

    def modify_matches(
        self,
        pred_matches: Sequence[Tuple[int, int]],
        gt_matches: Sequence[Tuple[int, int]],
        num_tracks: int,
        num_dets: int,
    ) -> List[Tuple[int, int]]:
        """Mix match decisions: with prob rate('det_match'), each GT match is
        forced; predicted matches that contradict a forced one are dropped."""
        p = self.rate("det_match")
        forced = [m for m in gt_matches if self.rng.rand() < p]
        taken_t = {t for t, _ in forced}
        taken_d = {d for _, d in forced}
        out = list(forced)
        for t, d in pred_matches:
            if t not in taken_t and d not in taken_d:
                out.append((t, d))
                taken_t.add(t)
                taken_d.add(d)
        return out

    def modify_newborns(self, pred_newborn: Sequence[int],
                        gt_newborn: Sequence[int]) -> List[int]:
        """Mix newborn-detection decisions (det_newborn semantics,
        tracking_decision_modifier.py:41-60)."""
        p = self.rate("det_newborn")
        out = set()
        for d in set(pred_newborn) | set(gt_newborn):
            use_gt = self.rng.rand() < p
            keep = (d in gt_newborn) if use_gt else (d in pred_newborn)
            if keep:
                out.add(d)
        return sorted(out)
