"""Stratified matching metrics (MatchingEval) + results aggregation.

A copy of point_cloud_reid_tpu/evaluation/matching.py (numpy only). The
port imports nothing of the JAX package, not even its numpy-only modules,
so it carries its own copy.

Behavioral rebuild of the reference metrics engine:
  f1_precision_recall            <- datasets/utils.py:254-276
  evaluate_points                <- datasets/utils.py:280-372 (power-of-2 point
                                    buckets x {at_least_one, at_least_both,
                                    for_a_pair})
  evaluate_distance              <- datasets/utils.py:375-459 (5m distance bins;
                                    NB the reference passes visibility in the
                                    num_points slot at the call site,
                                    reidentification_base.py:107-110 — we keep
                                    the same call contract)
  eval_per_visibility            <- datasets/utils.py:462-531
  evaluate_results               <- reidentification_base.py:87-199 (overall +
                                    per-class accuracy, JSON-able output)

Everything takes numpy arrays of logits (sigmoid applied here, matching the
reference) and returns plain dicts with stringified tuple keys so json.dump
works directly (make_tup_str equivalent).
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def f1_precision_recall(preds: np.ndarray, targets: np.ndarray,
                        prefix: str = "val_match_") -> Dict[str, float]:
    """Binary F1/precision/recall for both the positive and negative class.

    `preds` are already thresholded {0,1}. Keeps the reference's epsilon
    placement (including the quirky additive eps on the negative-class recall,
    datasets/utils.py:266-268) so numbers are comparable digit-for-digit.
    """
    preds = preds.astype(np.float64)
    targets = targets.astype(np.float64)
    pos = targets == 1
    recall_pos = preds[pos].sum() / (targets[pos].sum() + 1e-6)
    precision_pos = preds[pos].sum() / (preds.sum() + 1e-6)
    f1_pos = 2 * precision_pos * recall_pos / (precision_pos + recall_pos + 1e-6)

    neg = targets == 0
    recall_neg = (1 - preds[neg]).sum() / max((1 - targets[neg]).sum(), 1e-12) + 1e-6
    precision_neg = (1 - preds[neg]).sum() / max((1 - preds).sum(), 1e-12) + 1e-6
    f1_neg = 2 * precision_neg * recall_neg / (precision_neg + recall_neg + 1e-6)

    return {
        prefix + "f1_pos": float(f1_pos),
        prefix + "recall_pos": float(recall_pos),
        prefix + "precision_pos": float(precision_pos),
        prefix + "f1_neg": float(f1_neg),
        prefix + "recall_neg": float(recall_neg),
        prefix + "precision_neg": float(precision_neg),
    }


def _bucket_stats(preds: np.ndarray, targets: np.ndarray,
                  mask: np.ndarray) -> Dict[str, float]:
    p, t = preds[mask], targets[mask]
    d = f1_precision_recall(p, t)
    d["accuracy"] = float((p == t).mean()) if len(p) else -1.0
    d["num_observations_pos"] = int((t == 1).sum())
    d["num_observations_neg"] = int((t == 0).sum())
    return {k: (-1 if isinstance(v, float) and np.isnan(v) else v)
            for k, v in d.items()}


class MatchingEval:
    """Stratified evaluation over point-count / distance / visibility buckets."""

    def evaluate_points(self, logits: np.ndarray, targets: np.ndarray,
                        num_points: np.ndarray) -> Dict[str, Dict]:
        """Accuracy vs point count. num_points: (P, 2) per-pair raw counts.

        Buckets are [2^i, 2^{i+1}); three stratifications
        (datasets/utils.py:294-309):
          at_least_one  — max(count1, count2) >= 2^i
          at_least_both — min(count1, count2) >= 2^i
          for_a_pair    — (count1, count2) falls in the (i, j) bucket pair
        """
        preds = (_sigmoid(logits) > 0.5).astype(np.float64)
        n1, n2 = num_points[:, 0], num_points[:, 1]
        max_ = max(int(num_points.max()), 1)
        buckets = [2 ** i for i in range(int(np.log2(max_)) + 1)]

        at_least_one, at_least_both, for_a_pair = {}, {}, {}
        for i in range(len(buckets) - 1):
            lo = buckets[i]
            at_least_one[str((i, i + 1))] = _bucket_stats(
                preds, targets, np.maximum(n1, n2) >= lo)
            at_least_both[str((i, i + 1))] = _bucket_stats(
                preds, targets, np.minimum(n1, n2) >= lo)
        for i, j in itertools.combinations_with_replacement(
                range(len(buckets) - 1), 2):
            in_ij = (((buckets[i] <= n1) & (n1 < buckets[i + 1]) &
                      (buckets[j] <= n2) & (n2 < buckets[j + 1])) |
                     ((buckets[j] <= n1) & (n1 < buckets[j + 1]) &
                      (buckets[i] <= n2) & (n2 < buckets[i + 1])))
            for_a_pair[str(((i, i + 1), (j, j + 1)))] = _bucket_stats(
                preds, targets, in_ij)
        return dict(at_least_one=at_least_one, at_least_both=at_least_both,
                    for_a_pair=for_a_pair)

    def evaluate_distance(self, logits: np.ndarray, targets: np.ndarray,
                          distances: np.ndarray) -> Dict[str, Dict]:
        """Accuracy vs distance, 5m bins (datasets/utils.py:375-459).

        at_least_one / at_least_both use <= thresholds (closer than), matching
        the reference's inverted comparisons for distance."""
        preds = (_sigmoid(logits) > 0.5).astype(np.float64)
        d1, d2 = distances[:, 0].astype(np.float64), distances[:, 1].astype(
            np.float64)
        max_ = max(float(distances.max()), 1.0)
        buckets = [5 * i for i in range(int(max_ / 5) + 3)]

        at_least_one, at_least_both, for_a_pair = {}, {}, {}
        for i in range(len(buckets) - 1):
            lo = buckets[i]
            at_least_one[str((i, i + 1))] = _bucket_stats(
                preds, targets, np.minimum(d1, d2) <= lo)
            at_least_both[str((i, i + 1))] = _bucket_stats(
                preds, targets, np.maximum(d1, d2) <= lo)
        for i, j in itertools.combinations_with_replacement(
                range(len(buckets) - 1), 2):
            in_ij = (((buckets[i] <= d1) & (d1 < buckets[i + 1]) &
                      (buckets[j] <= d2) & (d2 < buckets[j + 1])) |
                     ((buckets[j] <= d1) & (d1 < buckets[j + 1]) &
                      (buckets[i] <= d2) & (d2 < buckets[i + 1])))
            for_a_pair[str(((i, i + 1), (j, j + 1)))] = _bucket_stats(
                preds, targets, in_ij)
        return dict(at_least_one=at_least_one, at_least_both=at_least_both,
                    for_a_pair=for_a_pair)

    def eval_per_visibility(self, logits: np.ndarray, targets: np.ndarray,
                            vis_classes: np.ndarray) -> Dict[str, Dict]:
        """Accuracy vs nuScenes visibility level 0-3 (datasets/utils.py:462-531).
        Pairs with target == -1 (FP) are excluded."""
        keep = targets != -1
        preds = (_sigmoid(logits[keep]) > 0.5).astype(np.float64)
        t = targets[keep]
        v1 = vis_classes[keep, 0].astype(np.int64)
        v2 = vis_classes[keep, 1].astype(np.int64)
        levels = [0, 1, 2, 3]

        at_least_one = {str(x): _bucket_stats(preds, t, np.maximum(v1, v2) >= x)
                        for x in levels}
        at_least_both = {str(x): _bucket_stats(preds, t, np.minimum(v1, v2) >= x)
                         for x in levels}
        for_a_pair = {}
        for x, y in itertools.combinations_with_replacement(levels, 2):
            mask = ((v1 == x) & (v2 == y)) | ((v1 == y) & (v2 == x))
            for_a_pair[str((x, y))] = _bucket_stats(preds, t, mask)
        return dict(at_least_one=at_least_one, at_least_both=at_least_both,
                    for_a_pair=for_a_pair)


def evaluate_results(results: Dict[str, np.ndarray],
                     cls_to_idx: Dict[str, int],
                     num_classes: int) -> Dict[str, object]:
    """Dataset-level aggregation (ReIDDatasetBase.evaluate,
    reidentification_base.py:87-199 + eval_match :69-84).

    Args:
        results: concatenated per-pair arrays with the forward_test keys
            (val_match_preds logits, val_match_gt, match_classes (P,2),
            num_points (P,2), val_vis_gt_all (P,2), optionally val_cls_preds/
            val_cls_gt/val_fp_preds/val_fp_gt and scalar val_*_loss means).
    Returns:
        dict with scalar metrics + nested stratified tables (JSON-able).
    """
    me = MatchingEval()
    out: Dict[str, object] = {}
    logits = results["val_match_preds"]
    gt = results["val_match_gt"]
    preds = (_sigmoid(logits) > 0.5).astype(np.float64)

    out["val_match_acc"] = float((preds == gt).mean())
    out.update(f1_precision_recall(preds, gt))

    match_classes = results["match_classes"]
    for cls_name, idx in cls_to_idx.items():
        if idx == -1:
            continue
        sel = match_classes[:, 0] == idx
        if sel.any():
            out[f"val_match_acc_{cls_name}"] = float(
                (preds[sel] == gt[sel]).mean())
    fp_sel = match_classes.max(axis=1) >= num_classes
    if fp_sel.any():
        out["val_match_acc_FP"] = float((preds[fp_sel] == gt[fp_sel]).mean())

    tables: Dict[str, object] = {}
    if "num_points" in results:
        tables["results_per_points"] = me.evaluate_points(
            logits, gt, results["num_points"])
        per_class = {}
        for cls_name, idx in cls_to_idx.items():
            if idx == -1:
                continue
            sel = ((match_classes[:, 0] == idx) | (match_classes[:, 1] == idx))
            if sel.any():
                per_class[cls_name] = dict(results_per_points=me.evaluate_points(
                    logits[sel], gt[sel], results["num_points"][sel]))
        tables["per_class"] = per_class
    if "val_vis_gt_all" in results:
        tables["results_per_visibility"] = me.eval_per_visibility(
            logits, gt, results["val_vis_gt_all"])
    if "distances" in results and (results["distances"] >= 0).any():
        # real per-frame ego BEV distances from the store — enables the
        # paper's accuracy-vs-distance analysis (reidentification_waymo.py:
        # 168-196, datasets/utils.py:375-459)
        tables["results_per_distance"] = me.evaluate_distance(
            logits, gt, np.maximum(results["distances"], 0.0))
    elif "val_vis_gt_all" in results:
        # fallback quirk parity: the reference feeds visibility into
        # evaluate_distance's slot at one call site
        # (reidentification_base.py:107-110); kept for output-shape parity
        # when the store carries no distance metadata
        tables["results_per_distance"] = me.evaluate_distance(
            logits, gt, np.maximum(results["val_vis_gt_all"], 0))

    if "val_cls_preds" in results:
        out["val_cls_acc"] = float(
            (results["val_cls_preds"].argmax(axis=1) ==
             results["val_cls_gt"]).mean())
    if "val_fp_preds" in results:
        out["val_fp_acc"] = float(
            (((_sigmoid(results["val_fp_preds"]) > 0.5).astype(np.float64)) ==
             results["val_fp_gt"]).mean())
    for k, v in results.items():
        if k.endswith("_loss"):
            out[k] = float(np.mean(v))
    out["stratified"] = tables
    return out
