"""Profiling: a torch.profiler trace of a region, and per-step wall timing.

Port of point_cloud_reid_tpu/utils/profiling.py: trace_context(log_dir)
wraps a region (tools/train.py --profile wraps Trainer.fit, as the JAX CLI
does) and writes a Chrome trace that chrome://tracing or Perfetto opens;
StepTimer gives per-step times that wait for the device.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the region (host ops, and the device's
    kernels where CUDA is available), written to {log_dir}/trace.json; a
    no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Per-step timer: stop() waits for the CUDA device (when there is
    one) before it reads the clock, so a step's queued kernels count."""

    def __init__(self):
        self.times = []
        self._t = None

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self._t = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def percentile(self, p: float) -> float:
        xs = sorted(self.times)
        if not xs:
            return 0.0
        return xs[min(int(len(xs) * p / 100), len(xs) - 1)]
