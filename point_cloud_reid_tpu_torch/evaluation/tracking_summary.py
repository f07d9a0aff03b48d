"""Tracking-eval summarization: association mistakes + track-length stats.

Rebuild of the live tables in the reference's tracking-eval pipeline —
get_mistakes_summary / get_metrics_summary / get_metrics_from_summary
(core/hooks/utils.py:26-242: mean/median track length, >1-length mean,
tracks-per-scene, track-length frequency table, per-class mistake counters)
and the CustomEval per-rank merge (core/hooks/multiprocessed_eval_hook.py:
39-120) — re-expressed for this framework's tracker: everything is plain
counters over host-side association decisions (the O(T*D) numeric work
already happened on device), and multi-host merge is a dict sum instead of a
tmpdir pickle gather.

Ground truth enters as per-detection gt object ids (>=0 real object,
-1 detector false positive); the accumulator tracks which gt identity each
track currently carries and classifies every association decision:

  correct        matched det gt == the identity the track carries
  id_switch      matched det gt is a DIFFERENT real object (identity broken)
  fp_match       track matched onto a false-positive detection
  missed         unmatched det whose gt is carried by an unmatched track
                 (the associator should have linked them)
  fragmentation  newborn track for a gt that an existing track still carries
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence

import numpy as np


class TrackingEvalAccumulator:
    """Accumulates association mistakes + track lifecycle stats per scene."""

    def __init__(self):
        self._track_gt: Dict[int, int] = {}    # track id -> gt id it carries
        self.counts: Counter = Counter()
        self.per_class: Dict[int, Counter] = {}
        self._frame_acc: List[float] = []
        self._lengths: List[int] = []          # completed-track lengths
        self._scene_tracks: List[int] = []     # tracks per scene
        self._scene_live: set = set()
        self.frames = 0
        self.scenes = 0

    # ---- per-frame recording --------------------------------------------------

    def _cls_counter(self, cls: int) -> Counter:
        return self.per_class.setdefault(int(cls), Counter())

    def observe_frame(self, matched: Sequence, newborn: Sequence,
                      unmatched_track_ids: Sequence[int],
                      unmatched_det_gt: Sequence[int]):
        """Record one frame of association decisions.

        Args:
            matched: (track_id, det_gt_id, det_cls) triples applied this frame.
            newborn: same triples for tracks born this frame.
            unmatched_track_ids: active tracks left unmatched.
            unmatched_det_gt: gt ids of dets that neither matched nor birthed
                (empty in the default tracker, which births every unmatched
                det; populated when a det-confidence gate drops them).
        """
        self.frames += 1
        ok = 0
        for tid, gt, cls in matched:
            tid, gt = int(tid), int(gt)
            carried = self._track_gt.get(tid, gt)
            c = self._cls_counter(cls)
            if gt < 0:
                self.counts["fp_match"] += 1
                c["fp_match"] += 1
            elif carried == gt:
                self.counts["correct"] += 1
                c["correct"] += 1
                ok += 1
            else:
                self.counts["id_switch"] += 1
                c["id_switch"] += 1
            self._track_gt[tid] = gt          # track carries this identity now
            self._scene_live.add(tid)

        carried_by_unmatched = {self._track_gt.get(int(t)): int(t)
                                for t in unmatched_track_ids}
        for tid, gt, cls in newborn:
            tid, gt = int(tid), int(gt)
            self._track_gt[tid] = gt
            self._scene_live.add(tid)
            if gt >= 0 and gt in carried_by_unmatched:
                self.counts["fragmentation"] += 1
                self._cls_counter(cls)["fragmentation"] += 1
        for gt in unmatched_det_gt:
            if int(gt) >= 0 and int(gt) in carried_by_unmatched:
                self.counts["missed"] += 1

        n_dec = len(matched)
        if n_dec:
            self._frame_acc.append(ok / n_dec)

    def observe_dead(self, tracks: Iterable):
        """Record lengths of pruned tracks (call when the store drops them)."""
        for t in tracks:
            self._lengths.append(int(t.hits))
            self._track_gt.pop(int(t.track_id), None)

    def end_scene(self, remaining_tracks: Iterable = ()):
        """Scene boundary: flush surviving tracks into the length stats."""
        self.observe_dead(remaining_tracks)
        self.scenes += 1
        self._scene_tracks.append(len(self._scene_live))
        self._scene_live = set()
        self._track_gt = {}

    # ---- merge + report -------------------------------------------------------

    def merge(self, other: "TrackingEvalAccumulator"):
        """Per-rank merge (CustomEval tmpdir-gather replacement)."""
        self.counts += other.counts
        for cls, c in other.per_class.items():
            self._cls_counter(cls).update(c)
        self._frame_acc += other._frame_acc
        self._lengths += other._lengths
        self._scene_tracks += other._scene_tracks
        self.frames += other.frames
        self.scenes += other.scenes
        return self

    def summary(self) -> Dict[str, object]:
        """JSON-able report (get_metrics_from_summary live fields +
        get_text_summary_mistakes tables, core/hooks/utils.py:156-306)."""
        c = self.counts
        eps = 1e-12
        correct = c["correct"]
        n_match_dec = correct + c["id_switch"] + c["fp_match"]
        lengths = np.asarray(self._lengths or [0])
        gt1 = lengths[lengths > 1]
        hist = Counter(int(x) for x in self._lengths)
        out = dict(
            frames=self.frames,
            scenes=self.scenes,
            association=dict(
                correct=int(correct),
                id_switches=int(c["id_switch"]),
                fp_matches=int(c["fp_match"]),
                missed=int(c["missed"]),
                fragmentations=int(c["fragmentation"]),
                precision=float(correct / (n_match_dec + eps)),
                recall=float(correct / (correct + c["missed"] + eps)),
                frame_match_acc=float(np.mean(self._frame_acc))
                if self._frame_acc else -1.0,
            ),
            per_class={str(k): dict(v) for k, v in
                       sorted(self.per_class.items())},
            track_stats=dict(
                mean_track_length=float(lengths.mean()),
                median_track_length=float(np.median(lengths)),
                mean_track_length_gt1=float(gt1.mean()) if len(gt1) else -1.0,
                mean_tracks_per_scene=float(np.mean(self._scene_tracks))
                if self._scene_tracks else -1.0,
                length_frequency={str(k): int(v)
                                  for k, v in sorted(hist.items())},
            ),
        )
        return out
