from .matching import MatchingEval, evaluate_results, f1_precision_recall

__all__ = ["MatchingEval", "evaluate_results", "f1_precision_recall"]
