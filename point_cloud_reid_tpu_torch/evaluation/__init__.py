"""Stratified ReID matching metrics and tracking-eval summaries.

tracking_summary.py is a copy of the JAX package's numpy-only module (its
evaluation/__init__.py imports jax, so it cannot be imported from there).
"""
from .matching import MatchingEval, evaluate_results, f1_precision_recall
from .tracking_summary import TrackingEvalAccumulator

__all__ = ["MatchingEval", "evaluate_results", "f1_precision_recall",
           "TrackingEvalAccumulator"]
