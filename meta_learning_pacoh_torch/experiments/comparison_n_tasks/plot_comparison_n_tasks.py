"""Plot test metric vs. number of meta-train tasks per learner (counterpart
of experiments/comparison_n_tasks/plot_comparison_n_tasks.py).

    python -m meta_learning_pacoh_torch.experiments.comparison_n_tasks.plot_comparison_n_tasks --csv path1.csv[,path2.csv] [--metric test_rmse|test_ll] [--output plot.png]

Reads the n-tasks sweep CSVs (baseline_comparison_n_tasks rows: algo,
dataset=<family>_<n>, n_train_tasks, seed, test_ll, test_rmse, calib_err),
drops the rows without the metric, takes n_train_tasks from the dataset's
name where no CSV has the column, and for each (family, learner, n_tasks)
the mean over seeds and the band 1.96 * std / max(1, sqrt(number of
seeds)), std the population std (ddof=0, ``np.std``), as the original. One
panel a family, families and learners sorted, the reference's label names,
a log task axis. The rows come from ``_cli.read_csv``, without pandas;
matplotlib is imported inside ``main`` only, as in the original: where it
is missing, ``main`` fails on that import.
"""

import numpy as np

from meta_learning_pacoh_torch.experiments._cli import FlagParser, missing, read_csv

# the reference's label names
LABELS = {
    "pacoh_map": "PACOH-MAP",
    "pacoh_vi": "PACOH-VI",
    "pacoh_svgd": "PACOH-SVGD",
    "gpr_meta_mll": "MLL",
    "neural_process": "NP",
    "maml": "MAML",
}


def parser():
    p = FlagParser(__doc__.splitlines()[0])
    p.string("csv", "./baseline_comparison_n_tasks.csv", "comma-separated sweep CSV paths")
    p.string("metric", "test_rmse", "test_rmse | test_ll")
    p.string("output", "./comparison_n_tasks.png", "output image")
    return p


def aggregate(rows, metric):
    """{family: {algo: [(n_tasks, mean, ci95), ...]}} over seeds."""
    derive = not any("n_train_tasks" in r for r in rows)
    rows = [r for r in rows if not missing(r.get(metric))]
    groups = {}
    for r in rows:
        n = int(r["dataset"].split("_")[-1]) if derive else r.get("n_train_tasks")
        key = (r["dataset"].split("_")[0], r.get("algo"), n)
        if not any(missing(k) for k in key):
            groups.setdefault(key, []).append(r[metric])
    out = {}
    for (family, algo, n) in sorted(groups):
        vals = np.asarray(groups[(family, algo, n)], dtype=float)
        ci = 1.96 * np.std(vals) / max(1.0, np.sqrt(len(vals)))
        out.setdefault(family, {}).setdefault(algo, []).append(
            (int(n), float(np.mean(vals)), float(ci)))
    for family in out.values():
        for algo in family:
            family[algo].sort()
    return out


def main(argv=None):
    """Draw the figure of the command line's CSVs (``argv`` None:
    ``sys.argv[1:]``); returns the aggregate."""
    args = parser().parse(argv)
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    from matplotlib.ticker import ScalarFormatter

    result = aggregate([row for path in args.csv.split(",") for row in read_csv(path)],
                       args.metric)
    if not result:
        print("no rows to plot")
        return result

    families = sorted(result)
    fig, axes = plt.subplots(1, len(families), figsize=(4 * len(families), 4), squeeze=False)
    ylabel = {"test_rmse": "test RMSE", "test_ll": "test LL"}[args.metric]
    for ax, family in zip(axes[0], families):
        for algo, rows in sorted(result[family].items()):
            x, y, ci = map(np.array, zip(*rows))
            ax.plot(x, y, label=LABELS.get(algo, algo))
            ax.fill_between(x, y - ci, y + ci, alpha=0.2)
        ax.set_title(family)
        ax.set_xscale("log")
        ax.set_xlabel("number of tasks")
        ax.set_ylabel(ylabel)
        ax.set_xticks(sorted({r[0] for rs in result[family].values() for r in rs}))
        ax.xaxis.set_major_formatter(ScalarFormatter())
    axes[0][0].legend()
    fig.tight_layout()
    fig.savefig(args.output, dpi=150)
    print(f"wrote {args.output}")
    return result


if __name__ == "__main__":
    main()
