"""Serialized multi-run launcher of the port (the JAX package's
tools/launcher.py; the reference's launcher_training.py /
launcher_testing.py): runs a list of (experiment, extra-args) jobs back to
back through `python -m point_cloud_reid_tpu_torch.tools.<tool>`, logging
each run's status.

    python -m point_cloud_reid_tpu_torch.tools.launcher \
        --jobs jobs.json [--tool test] [--dry-run] [--stop-on-error]

jobs.json: [{"experiment": "...", "args": ["--epochs", "2"]}, ...]
Without --jobs it runs the released training matrix (the point models on
nuScenes). --dry-run lists the commands without running them. Each job is
its own process on the CUDA device (add "--device", "cpu" to a job's args
for the CPU).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

DEFAULT_JOBS = [
    {"experiment": "pts_point-transformer_point-cat_nus_det_4x256_500e",
     "args": []},
    {"experiment": "pts_pointnet_point-cat_nus_det_4x256_500e", "args": []},
    {"experiment": "pts_dgcnn_point-cat_nus_det_4x256_500e", "args": []},
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", default=None, help="JSON job list")
    ap.add_argument("--tool", default="train", choices=["train", "test"])
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--stop-on-error", action="store_true")
    args = ap.parse_args(argv)

    jobs = DEFAULT_JOBS
    if args.jobs:
        with open(args.jobs) as f:
            jobs = json.load(f)

    results = []
    for job in jobs:
        cmd = [sys.executable, "-m",
               f"point_cloud_reid_tpu_torch.tools.{args.tool}",
               job["experiment"], *job.get("args", [])]
        print(f"[launcher] {' '.join(cmd)}", file=sys.stderr)
        if args.dry_run:
            results.append(dict(job=job, cmd=cmd, status="dry-run"))
            continue
        t0 = time.time()
        proc = subprocess.run(cmd)
        results.append(dict(job=job, cmd=cmd, status="ok"
                            if proc.returncode == 0
                            else f"exit {proc.returncode}",
                            seconds=round(time.time() - t0, 1)))
        if proc.returncode != 0 and args.stop_on_error:
            break
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
