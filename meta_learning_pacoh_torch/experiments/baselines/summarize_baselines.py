"""Aggregate a baseline_comparison CSV into a mean/std table per (dataset,
algo) (counterpart of experiments/baselines/summarize_baselines.py).

    python -m meta_learning_pacoh_torch.experiments.baselines.summarize_baselines [--csv PATH]

The six statistics and ``n_seeds`` are pandas' ``groupby(["dataset",
"algo"]).agg(...)`` of the original, number for number (the sample std,
NaN skipped).
"""

from meta_learning_pacoh_torch.experiments._cli import (
    FlagParser,
    format_table,
    group_stats,
    read_csv,
)

STATS = {
    "test_ll_mean": ("test_ll", "mean"), "test_ll_std": ("test_ll", "std"),
    "rmse_mean": ("test_rmse", "mean"), "rmse_std": ("test_rmse", "std"),
    "calib_mean": ("calib_err", "mean"), "calib_std": ("calib_err", "std"),
    "n_seeds": ("seed", "count"),
}


def parser():
    p = FlagParser(__doc__.splitlines()[0])
    p.string("csv", "./baseline_comparison.csv", "input CSV")
    return p


def summarize(path):
    """[((dataset, algo), {statistic: value})] in sorted key order."""
    return group_stats(read_csv(path), ["dataset", "algo"], STATS)


def main(argv=None, device=None):
    """Print and return the summary of the CSV the command line names (no
    computation runs on ``device``; it is taken as every CLI's is)."""
    args = parser().parse(argv)
    summary = summarize(args.csv)
    print(format_table(["dataset", "algo"], [list(STATS)],
                       [(key, list(vals.values())) for key, vals in summary]))
    return summary


if __name__ == "__main__":
    main()
