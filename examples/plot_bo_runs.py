"""Cross-seed BO-run regret plotter.

The reference ships this as a notebook (examples/notebooks/plot_bo_runs.ipynb:
read per-seed y traces, cumulative-min, mean +/- std band, optimum hline).
Here it is a scripted driver over the bark_study CSV format
(``experiments_{benchmark}_{strategy}_seed={s}.csv`` with ``y``/``best``
columns, examples/bark_study.py): group runs by strategy, aggregate the
incumbent-best trace across seeds, write one figure and a JSON summary.

Usage::

    python examples/plot_bo_runs.py results/regret_r2 \
        [--optimum -1.9] [--out results/diagnostics/bo_runs.png]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

_PAT = re.compile(r"experiments_(?P<bench>.+)_(?P<strategy>[^_]+)_seed=(?P<seed>\d+)\.csv")


def load_runs(directory: pathlib.Path):
    """{(bench, strategy): [per-seed best-so-far traces]} from study CSVs."""
    import csv

    runs = {}
    for path in sorted(directory.glob("experiments_*.csv")):
        m = _PAT.match(path.name)
        if not m:
            continue
        with open(path, newline="") as fh:
            reader = csv.DictReader(fh)
            ys = [float(row["y"]) for row in reader]
        if not ys:
            continue
        best = np.minimum.accumulate(np.asarray(ys, np.float64))
        runs.setdefault((m["bench"], m["strategy"]), []).append(best)
    return runs


def aggregate(traces):
    """Mean / std of best-so-far across seeds, truncated to the common length."""
    n = min(len(t) for t in traces)
    arr = np.stack([t[:n] for t in traces])
    return arr.mean(axis=0), arr.std(axis=0, ddof=1 if len(traces) > 1 else 0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("directory", help="bark_study output dir with experiments_*.csv")
    ap.add_argument("--benchmark", default=None, help="filter by benchmark name")
    ap.add_argument("--optimum", type=float, default=None,
                    help="known optimum: draws the hline and converts the "
                         "summary to simple regret")
    ap.add_argument("--out", default=None, help="figure path (.png)")
    ap.add_argument("--summary-out", default=None, help="JSON summary path")
    args = ap.parse_args()

    directory = pathlib.Path(args.directory)
    runs = load_runs(directory)
    if args.benchmark:
        runs = {k: v for k, v in runs.items() if k[0] == args.benchmark}
    if not runs:
        raise SystemExit(f"no experiments_*.csv runs found in {directory}")

    from bark_jax.utils.plots import plt, save_fig

    fig, ax = plt.subplots(figsize=(6, 4))
    summary = {}
    for (bench, strategy), traces in sorted(runs.items()):
        mean, std = aggregate(traces)
        x = np.arange(1, len(mean) + 1)
        ax.plot(x, mean, label=f"{strategy} ({len(traces)} seeds)")
        ax.fill_between(x, mean - std, mean + std, alpha=0.3)
        entry = {
            "seeds": len(traces),
            "iterations": int(len(mean)),
            "final_best_mean": float(mean[-1]),
            "final_best_std": float(std[-1]),
        }
        if args.optimum is not None:
            entry["final_regret_mean"] = float(mean[-1] - args.optimum)
        summary[f"{bench}/{strategy}"] = entry
    if args.optimum is not None:
        ax.axhline(args.optimum, linestyle="--", color="gray", label="optimum")
    ax.set_xlabel("iteration")
    ax.set_ylabel("best objective so far")
    ax.set_title(", ".join(sorted({b for b, _ in runs})))
    ax.legend()

    out = pathlib.Path(args.out) if args.out else (
        directory / "bo_runs.png"
    )
    save_fig(fig, out)
    summary_path = pathlib.Path(args.summary_out) if args.summary_out else (
        out.with_suffix(".json")
    )
    summary_path.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    print(f"wrote {out} and {summary_path}", flush=True)


if __name__ == "__main__":
    main()
