"""Tracking mistake-analysis figures from a tracking-eval summary JSON.

Matplotlib companion to evaluation/tracking_summary.py — the figure families
the reference draws in its tracking-eval hook (show_mistakes_ids_pct pies,
plot_track_length_frequency bars, show_metrics_decisions grouped bars;
reference mmdet3d/core/hooks/utils.py:306-474):

  mistake_share.png          association-decision outcome shares (overall)
  mistake_share_<class>.png  the same per class
  track_length_frequency.png log-scale track-length histogram (+ a >1-only
                             panel, plot_track_length_frequency)
  decision_metrics.png       precision / recall / frame-match-acc bars

    python -m point_cloud_reid_tpu_torch.tools.tracking_plots \
        tracking_summary.json --out plots/

The port's copy of the JAX package's tools/tracking_plots.py. The input is
TrackingEvalAccumulator.summary() JSON: the tracking_summary.json that the
port's tools/track.py writes. matplotlib is imported only inside the
drawing functions.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

MISTAKE_KEYS = ("correct", "id_switch", "fp_match", "missed", "fragmentation")
ALIASES = {"id_switches": "id_switch", "fp_matches": "fp_match",
           "fragmentations": "fragmentation"}


def _shares(counter: dict) -> dict:
    data = {}
    for k, v in counter.items():
        k = ALIASES.get(k, k)
        if k in MISTAKE_KEYS and v > 0:
            data[k] = data.get(k, 0) + int(v)
    return data


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _pie(data: dict, title: str, path: str):
    if not data:
        return None
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 7))
    labels = list(data)
    sizes = [data[k] for k in labels]
    ax.pie(sizes, labels=labels, autopct="%1.1f%%", startangle=90)
    ax.axis("equal")
    ax.set_title(title, y=1.05)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def _length_frequency(freq: dict, out: str) -> str:
    plt = _pyplot()
    xs = np.arange(max(freq) + 1)
    ys = np.array([freq.get(int(x), 0) for x in xs])
    fig, axes = plt.subplots(2, 1, figsize=(20, 8))
    axes[0].bar(xs, ys)
    axes[0].set_yscale("log")
    axes[0].set_title("Log scale chart of track length frequency")
    ys2 = ys.copy()
    if len(ys2) > 1:
        ys2[1] = 0          # 'excluding 1' panel
    axes[1].bar(xs, ys2)
    axes[1].set_title("Track length frequency, excluding length-1 tracks")
    path = os.path.join(out, "track_length_frequency.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def _decision_bars(bars: dict, out: str) -> str:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    x = np.arange(len(bars))
    ax.bar(x, list(bars.values()), width=0.5)
    ax.set_xticks(x, list(bars))
    ax.set_ylim(0, 1.05)
    ax.set_ylabel("Score")
    ax.set_title("Tracking decision metrics")
    path = os.path.join(out, "decision_metrics.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("summary", help="tracking summary JSON")
    ap.add_argument("--out", default="tracking_plots")
    args = ap.parse_args(argv)
    with open(args.summary) as f:
        s = json.load(f)
    os.makedirs(args.out, exist_ok=True)
    written = []

    # 1. association-outcome shares, overall + per class (the reference's
    #    show_mistakes_ids_pct pie family)
    p = _pie(_shares(s.get("association", {})),
             "Association decision outcomes (validation)",
             os.path.join(args.out, "mistake_share.png"))
    if p:
        written.append(p)
    for cls, counter in sorted(s.get("per_class", {}).items()):
        p = _pie(_shares(counter),
                 f"Association decision outcomes — class {cls}",
                 os.path.join(args.out, f"mistake_share_{cls}.png"))
        if p:
            written.append(p)

    # 2. track-length frequency (log-scale + >1-only panels)
    freq = {int(k): int(v) for k, v in
            s.get("track_stats", {}).get("length_frequency", {}).items()}
    if freq:
        written.append(_length_frequency(freq, args.out))

    # 3. decision metrics bars (show_metrics_decisions)
    assoc = s.get("association", {})
    bars = {k: assoc[k] for k in ("precision", "recall", "frame_match_acc")
            if isinstance(assoc.get(k), (int, float)) and assoc[k] >= 0}
    if bars:
        written.append(_decision_bars(bars, args.out))

    print(json.dumps(dict(plots=written)))


if __name__ == "__main__":
    main()
