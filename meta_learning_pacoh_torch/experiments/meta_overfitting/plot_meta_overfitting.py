"""Paper-style meta-overfitting plot: meta-train vs meta-test RMSE over the
number of meta-train tasks (counterpart of
experiments/meta_overfitting/plot_meta_overfitting.py).

    python -m meta_learning_pacoh_torch.experiments.meta_overfitting.plot_meta_overfitting [--flag value ...]

Reads the CSVs run_overfitting_sweep writes (one panel each), keeps the
rows with at least ``--min_n_tasks`` tasks, aggregates the two RMSE columns
over seeds, with ``--select_best_wd`` keeps for each task count the weight
decay whose mean meta-test RMSE is least (ties to the smallest weight decay,
as pandas' ``idxmin`` over the sorted groups), prints the table and draws
each mean with a 95% band, 1.96 std / sqrt(number of seeds), on a log task
axis.

The statistics are the original's numbers. It aggregates with
``[np.mean, np.std]`` through pandas, which (pandas 3) calls each on the
group's column: the mean and the population std (ddof=0) of the values that
are not NaN, NaN where none is. Here they come from ``_cli.group_stats`` on
the rows of ``_cli.read_csv``, without pandas. matplotlib is imported
inside ``main`` only, as in the original: where it is missing, ``main``
fails on that import.
"""

import numpy as np

from meta_learning_pacoh_torch.experiments._cli import (
    FlagParser,
    format_table,
    group_stats,
    missing,
    read_csv,
)

METRICS = (("test_rmse_meta_train", "meta-train tasks"),
           ("test_rmse_meta_test", "meta-test tasks"))
# (metric, statistic) -> the group_stats aggregate: the mean and the population std
STATS = {(metric, stat): (metric, agg) for metric, _ in METRICS
         for stat, agg in (("mean", "mean"), ("std", "pstd"))}
SCORE = ("test_rmse_meta_test", "mean")


def parser():
    p = FlagParser(__doc__.splitlines()[0])
    p.string("csvs", "./meta_overfitting.csv", "comma-separated sweep CSVs (one panel each)")
    p.string("output", "./meta_overfitting.png", "output figure path")
    p.boolean("select_best_wd", True,
              "pick the weight_decay minimizing mean meta-test RMSE per n_tasks (the "
              "reference's PACOH-MAP aggregation)")
    p.integer("min_n_tasks", 4, "drop rows below this task count")
    return p


def aggregate(rows, select_best_wd, min_n_tasks):
    """[(n_tasks, {(metric, 'mean' | 'std'): value})] in increasing n_tasks."""
    rows = [r for r in rows if not missing(r.get("n_tasks")) and r["n_tasks"] >= min_n_tasks]
    if select_best_wd and len({r["weight_decay"] for r in rows
                               if not missing(r.get("weight_decay"))}) > 1:
        cells = group_stats(rows, ["n_tasks", "weight_decay"], STATS)
        out = []
        for n_tasks in sorted({r["n_tasks"] for r in rows}):
            scored = [stats for (n, _), stats in cells
                      if n == n_tasks and not missing(stats[SCORE])]
            if not scored:
                raise ValueError(f"n_tasks={n_tasks}: no weight decay has a meta-test RMSE")
            out.append((n_tasks, min(scored, key=lambda stats: stats[SCORE])))
        return out
    return [(key[0], stats) for key, stats in group_stats(rows, ["n_tasks"], STATS)]


def table_text(agg):
    columns = list(STATS)
    return format_table(["n_tasks"], [[m for m, _ in columns], [s for _, s in columns]],
                        [((n,), [stats[c] for c in columns]) for n, stats in agg])


def main(argv=None):
    """Draw the figure of the command line's CSVs (``argv`` None:
    ``sys.argv[1:]``); returns {csv path: its aggregate}."""
    args = parser().parse(argv)
    from matplotlib import pyplot as plt

    csvs = args.csvs.split(",")
    fig, axes = plt.subplots(1, len(csvs), figsize=(4.5 * len(csvs), 3), squeeze=False)
    out = {}
    for ax, csv_path in zip(axes[0], csvs):
        rows = read_csv(csv_path)
        n_seeds = max(len({r["seed"] for r in rows if not missing(r.get("seed"))}), 1)
        agg = out[csv_path] = aggregate(rows, args.select_best_wd, args.min_n_tasks)
        print(f"----- {csv_path} -----")
        print(table_text(agg), "\n")
        x = np.asarray([n for n, _ in agg], dtype=float)
        for metric, label in METRICS:
            y = np.asarray([stats[(metric, "mean")] for _, stats in agg], dtype=float)
            s = np.asarray([stats[(metric, "std")] for _, stats in agg], dtype=float)
            ci = 1.96 * s / np.sqrt(n_seeds)
            ax.plot(x, y, label=label)
            ax.fill_between(x, y - ci, y + ci, alpha=0.2)
        ax.set_title(str(rows[0]["dataset"]) if rows else csv_path)
        ax.set_xscale("log")
        ax.set_xlabel("number of tasks")
        ax.set_ylabel("test RMSE")
        ax.legend()
    fig.tight_layout()
    fig.savefig(args.output, dpi=150)
    print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
