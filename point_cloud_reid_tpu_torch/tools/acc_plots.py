"""Stratified-accuracy plots from eval JSON reports (multi-run overlays,
1-D bucket curves, pair-bucket heatmaps + per-bucket curve families).

Full-capability port of the reference plotting tool
(tools/acc_plots_tool.py:10-473):

  plot_metrics_1d        <- :10-127  (log2 x-axis, % y, metric filter via
                            include substrings, per-bucket positive/negative
                            observation counts in the tick labels)
  JSONToPlots.merge_data <- :180-197 (multi-run merge: metrics from run R
                            become 'R--metric' so several runs overlay in
                            one figure)
  use_densities mode     <- :209-241 (for each bucket b, the accuracy of
                            (b, x) pairs as a curve over x — the paper's
                            pair-bucket analysis) + a 2-D heatmap the
                            reference renders via notebook snippets
  per-class / visibility / distance variants <- :305-531

The port's copy of the JAX package's tools/acc_plots.py. Its input is the
eval_results_full.json that the port's tools/test.py writes; matplotlib is
imported only inside the drawing functions.

Usage:
    python -m point_cloud_reid_tpu_torch.tools.acc_plots \
        run_a/eval_results_full.json run_b/eval_results_full.json \
        --labels A B --out plots/
    python -m point_cloud_reid_tpu_torch.tools.acc_plots report.json \
        --pair-buckets --metrics acc f1
"""
from __future__ import annotations

import argparse
import ast
import itertools
import json
import os

import numpy as np


def _bucket_sort_key(key: str):
    try:
        k = ast.literal_eval(key)
        return k if isinstance(k, tuple) else (k,)
    except (ValueError, SyntaxError):
        return (key,)


def merge_runs(tables_by_run: dict) -> dict:
    """{run: {mode: {bucket: {metric: v}}}} -> {mode: {bucket:
    {'run--metric': v, num_observations_*: v}}} (merge_data parity)."""
    out: dict = {}
    for run, modes in tables_by_run.items():
        for mode, buckets in modes.items():
            m = out.setdefault(mode, {})
            for bucket, stats in buckets.items():
                b = m.setdefault(bucket, {})
                for metric, v in stats.items():
                    if "num_observations" in metric:
                        b[metric] = v
                    else:
                        b[f"{run}--{metric}"] = v
    return out


def plot_metrics_1d(table: dict, include: list, title: str, xlabel: str,
                    out_path: str, log2_x: bool = True):
    """One overlay figure for a single stratification mode.

    Curves: every 'run--metric' whose metric name contains one of the
    `include` substrings; x ticks carry the per-bucket positive/negative
    observation counts (plot_metrics_1d parity, acc_plots_tool.py:10-127).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = sorted(table.keys(), key=_bucket_sort_key)
    pos_obs = np.array([table[k].get("num_observations_pos", 0) for k in keys])
    neg_obs = np.array([table[k].get("num_observations_neg", 0) for k in keys])
    xticks = np.array([2.0 ** i for i in range(len(keys))])

    metric_names = sorted({m for k in keys for m in table[k]
                           if "num_observations" not in m
                           and any(s in m for s in include)})
    fig, ax = plt.subplots(figsize=(8, 5))
    markers = itertools.cycle("Dosv^P*X")
    for m in metric_names:
        y = np.array([float(table[k].get(m, -1)) for k in keys])
        obs = neg_obs if "neg" in m else pos_obs
        keep = (y != -1) & (obs != 0)
        if not keep.any():
            continue
        ax.plot(xticks[keep], y[keep] * 100, label=m, linewidth=1.2,
                marker=next(markers), markersize=4, linestyle="--")
    ax.grid(linestyle="-", alpha=0.4)
    if metric_names:
        ax.legend(fontsize=8)
    ax.set_title(title)
    ax.set_xlabel(xlabel + "\npositive / negative observations", fontsize=9)
    ax.set_ylabel("metric (%)", fontsize=9)
    if log2_x:
        ax.set_xscale("log", base=2)
    ax.set_xticks(xticks)
    ax.set_xticklabels([f"{k}\n{p}\n{n}" for k, p, n in
                        zip(keys, pos_obs, neg_obs)], fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_pair_heatmap(for_a_pair: dict, metric: str, title: str,
                      out_path: str):
    """(bucket_i, bucket_j) -> metric as a 2-D heatmap."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cells = {}
    n = 0
    for key, stats in for_a_pair.items():
        try:
            (i, _), (j, _) = ast.literal_eval(key)
        except (ValueError, SyntaxError, TypeError):
            continue
        cells[(i, j)] = float(stats.get(metric, -1))
        n = max(n, i + 1, j + 1)
    grid = np.full((n, n), np.nan)
    for (i, j), v in cells.items():
        if v != -1:
            grid[i, j] = grid[j, i] = v * 100

    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(grid, origin="lower", vmin=0, vmax=100, cmap="viridis")
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels([f"$2^{{{i}}}$" for i in range(n)], fontsize=8)
    ax.set_yticklabels([f"$2^{{{i}}}$" for i in range(n)], fontsize=8)
    ax.set_xlabel("#points object 2")
    ax.set_ylabel("#points object 1")
    ax.set_title(title)
    for i in range(n):
        for j in range(n):
            if np.isfinite(grid[i, j]):
                ax.text(j, i, f"{grid[i, j]:.0f}", ha="center", va="center",
                        fontsize=6,
                        color="w" if grid[i, j] < 60 else "k")
    fig.colorbar(im, ax=ax, label=f"{metric} (%)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_pair_bucket_curves(for_a_pair: dict, include: list, out_dir: str,
                            prefix: str):
    """use_densities mode (acc_plots_tool.py:209-241): for each bucket b, a
    figure of pair accuracy (b, x) as a curve over x."""
    rows = {}
    for key, stats in for_a_pair.items():
        try:
            (i, _), (j, _) = ast.literal_eval(key)
        except (ValueError, SyntaxError, TypeError):
            continue
        rows.setdefault(i, {})[str((j, j + 1))] = stats
        rows.setdefault(j, {})[str((i, i + 1))] = stats
    written = []
    for b, table in sorted(rows.items()):
        written.append(plot_metrics_1d(
            table, include,
            title=f"pairs with one object in $[2^{{{b}}}, 2^{{{b + 1}}})$ pts",
            xlabel="#points of the other object",
            out_path=os.path.join(out_dir,
                                  f"{prefix}_pair_bucket_{b}.png")))
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("reports", nargs="+",
                    help="eval_results_full.json file(s) from tools.test; "
                         "several overlay in one figure per mode")
    ap.add_argument("--labels", nargs="*", default=None,
                    help="run labels (default: file basenames)")
    ap.add_argument("--out", default="plots")
    ap.add_argument("--metrics", nargs="*", default=["acc"],
                    help="metric-name substrings to include (e.g. acc f1)")
    ap.add_argument("--pair-buckets", action="store_true",
                    help="also render the for_a_pair heatmap + per-bucket "
                         "curve families")
    args = ap.parse_args(argv)

    labels = args.labels or [os.path.splitext(os.path.basename(p))[0]
                             for p in args.reports]
    runs = {}
    for label, path in zip(labels, args.reports):
        with open(path) as f:
            runs[label] = json.load(f).get("stratified", {})

    os.makedirs(args.out, exist_ok=True)
    written = []

    xlabels = dict(results_per_points="#points",
                   results_per_visibility="visibility level",
                   results_per_distance="distance bucket (5 m)")
    for name, xlabel in xlabels.items():
        per_run = {r: t[name] for r, t in runs.items() if name in t}
        if not per_run:
            continue
        merged = merge_runs(per_run)
        for mode in ("at_least_one", "at_least_both"):
            if mode in merged:
                written.append(plot_metrics_1d(
                    merged[mode], args.metrics,
                    title=f"{name} ({mode})", xlabel=xlabel,
                    out_path=os.path.join(args.out,
                                          f"{name}_{mode}.png"),
                    log2_x=(name == "results_per_points")))
        if args.pair_buckets and "for_a_pair" in merged:
            first = next(iter(per_run.values()))
            if "for_a_pair" in first:
                written.append(plot_pair_heatmap(
                    first["for_a_pair"], "accuracy",
                    f"{labels[0]}: {name} pair buckets",
                    os.path.join(args.out, f"{name}_pair_heatmap.png")))
            written.extend(plot_pair_bucket_curves(
                merged["for_a_pair"], args.metrics, args.out, name))

    # per-class accuracy-vs-points (get_results per class, :200+)
    classes = sorted({c for t in runs.values()
                      for c in t.get("per_class", {})})
    for cls in classes:
        per_run = {r: t["per_class"][cls]["results_per_points"]
                   for r, t in runs.items()
                   if cls in t.get("per_class", {})}
        merged = merge_runs(per_run)
        if "at_least_both" in merged:
            written.append(plot_metrics_1d(
                merged["at_least_both"], args.metrics,
                title=f"{cls}: accuracy vs #points (at_least_both)",
                xlabel="#points",
                out_path=os.path.join(args.out, f"points_{cls}.png")))

    print(json.dumps(dict(plots=written)))


if __name__ == "__main__":
    main()
