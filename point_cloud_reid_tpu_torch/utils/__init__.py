from .logging import MetricLogger

__all__ = ["MetricLogger"]
