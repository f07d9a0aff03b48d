"""Structured metric logging: stdout + JSONL writers, no cloud dependency.

A copy of point_cloud_reid_tpu/utils/logging.py (that package's __init__
imports jax, so the port cannot import it).

The reference hard-requires Neptune (README "disabling neptune logging causes
errors"; hooks at core/hooks/log_config_hook.py, save_model_to_neptune_hook.py,
eval hook scanning runner._hooks for the run object, eval_hook.py:145-151).
Here every sink implements write(record) and is optional; JSONL files are the
artifact store (configs, eval tables, per-iter scalars).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


def _to_jsonable(x):
    try:
        import numpy as np
        if isinstance(x, (np.generic,)):
            return x.item()
        if hasattr(x, "shape") and getattr(x, "shape") == ():
            return float(x)
        if isinstance(x, np.ndarray):
            return x.tolist()
    except Exception:
        pass
    return x


class MetricLogger:
    """stdout + JSONL metric sink.

    Args:
        work_dir: if set, appends records to {work_dir}/metrics.jsonl and
            eval tables to {work_dir}/eval.jsonl.
        stdout_interval: print every record by default.
    """

    def __init__(self, work_dir: Optional[str] = None, quiet: bool = False):
        self.work_dir = work_dir
        self.quiet = quiet
        if work_dir:
            os.makedirs(work_dir, exist_ok=True)
        self._t0 = time.time()

    def _write(self, filename: str, record: Dict[str, Any]):
        record = {k: _to_jsonable(v) for k, v in record.items()}
        record["wall_s"] = round(time.time() - self._t0, 3)
        if self.work_dir:
            with open(os.path.join(self.work_dir, filename), "a") as f:
                f.write(json.dumps(record) + "\n")
        if not self.quiet:
            brief = {k: (round(v, 5) if isinstance(v, float) else v)
                     for k, v in record.items()
                     if not isinstance(v, (list, dict))}
            print(json.dumps(brief), file=sys.stderr)

    def log_train(self, step: int, epoch: int, log_vars: Dict[str, Any],
                  extra: Optional[Dict[str, Any]] = None):
        rec = dict(kind="train", step=step, epoch=epoch)
        rec.update({k: _to_jsonable(v) for k, v in log_vars.items()})
        if extra:
            rec.update(extra)
        self._write("metrics.jsonl", rec)

    def log_eval(self, step: int, epoch: int, metrics: Dict[str, Any]):
        flat = {k: v for k, v in metrics.items() if not isinstance(v, dict)}
        rec = dict(kind="eval", step=step, epoch=epoch, **flat)
        self._write("metrics.jsonl", rec)
        if self.work_dir:
            with open(os.path.join(self.work_dir, "eval.jsonl"), "a") as f:
                f.write(json.dumps(
                    {k: _to_jsonable(v) for k, v in metrics.items()}) + "\n")

    def log_config(self, cfg: Dict[str, Any]):
        """Persist the resolved config (replaces the UploadConfig Neptune hook,
        core/hooks/log_config_hook.py:5-28)."""
        if self.work_dir:
            with open(os.path.join(self.work_dir, "config.json"), "w") as f:
                json.dump(cfg, f, indent=1, default=str)
