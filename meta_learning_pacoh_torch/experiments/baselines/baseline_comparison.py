"""Cross-algorithm baseline comparison: datasets x algorithms x seeds -> CSV
(counterpart of experiments/baselines/baseline_comparison.py).

    python -m meta_learning_pacoh_torch.experiments.baselines.baseline_comparison [--flag value ...]

Each (algo, dataset, seed) cell trains a learner and records test
LL/RMSE/calibration, one cell after another. As in the original, a cell
that raises is printed ("FAILED ...") and recorded as a NaN row, and the
sweep goes on; ``main`` also returns how many cells failed, so a caller can
tell such a run from a clean one.
"""

import math
import time

from meta_learning_pacoh_torch.datasets import provide_data
from meta_learning_pacoh_torch.experiments._cli import FlagParser, Outcome, int_list, write_csv

NAN_METRICS = {"test_ll": math.nan, "test_rmse": math.nan, "calib_err": math.nan,
               "fit_time": math.nan}


def add_flags(p):
    p.string("datasets", "sin_20,cauchy_20", "comma-separated dataset keys")
    p.string("algos", "pacoh_map,pacoh_svgd,pacoh_vi,maml,np", "algorithms")
    p.string("seeds", "22,23,24,25,26", "comma-separated seeds")
    p.integer("n_iter_fit", 10000, "meta-train iterations")
    p.integer("n_test_tasks", 50, "test tasks to evaluate")
    p.string("output_csv", "./baseline_comparison.csv", "output CSV")
    return p


def parser():
    return add_flags(FlagParser(__doc__.splitlines()[0]))


def build_cell(algo, train, seed, n_iter_fit, device=None):
    """The learner of one cell (the original's run_cell, :42-54)."""
    from meta_learning_pacoh_torch import (
        GPRegressionMetaLearned,
        GPRegressionMetaLearnedSVGD,
        GPRegressionMetaLearnedVI,
        MAMLRegression,
        NPRegressionMetaLearned,
    )

    common = dict(num_iter_fit=n_iter_fit, random_seed=seed, device=device)
    if algo == "pacoh_map":
        return GPRegressionMetaLearned(train, weight_decay=0.2, **common)
    if algo == "pacoh_svgd":
        return GPRegressionMetaLearnedSVGD(train, **common)
    if algo == "pacoh_vi":
        return GPRegressionMetaLearnedVI(train, **common)
    if algo == "maml":
        return MAMLRegression(train, **common)
    if algo == "np":
        return NPRegressionMetaLearned(train, **common)
    raise ValueError(algo)


def run_cell(algo, dataset, seed, n_iter_fit, n_test_tasks, device=None):
    train, _, test = provide_data(dataset, seed=seed)
    test = test[:n_test_tasks]
    model = build_cell(algo, train, seed, n_iter_fit, device)

    t0 = time.time()
    model.meta_fit(verbose=False, log_period=n_iter_fit)
    fit_time = time.time() - t0

    if algo == "maml":
        rmse = model.eval_datasets(test)
        return {"test_ll": math.nan, "test_rmse": rmse, "calib_err": math.nan,
                "fit_time": fit_time}
    ll, rmse, calib = model.eval_datasets(test)
    return {"test_ll": ll, "test_rmse": rmse, "calib_err": calib, "fit_time": fit_time}


def sweep(cells, args, device=None):
    """Run ``cells`` ([(row base, algo, dataset, seed)]), rewriting the CSV
    after every row; a cell that raises becomes a NaN row."""
    rows, failed = [], 0
    for base, algo, dataset, seed in cells:
        try:
            metrics = run_cell(algo, dataset, seed, args.n_iter_fit, args.n_test_tasks, device)
        except Exception as e:
            print(f"FAILED {base}: {e!r}")
            metrics = dict(NAN_METRICS)
            failed += 1
        rows.append({**base, **metrics})
        print(rows[-1])
        write_csv(rows, args.output_csv)
    print(f"wrote {len(rows)} rows to {args.output_csv}")
    return Outcome(rows, failed, 0)


def main(argv=None, device=None):
    """Run the sweep of the command line ``argv`` (None: ``sys.argv[1:]``) on
    ``device`` (None: the card); returns its Outcome."""
    args = parser().parse(argv)
    cells = [({"algo": algo, "dataset": dataset, "seed": seed}, algo, dataset, seed)
             for dataset in args.datasets.split(",")
             for algo in args.algos.split(",")
             for seed in int_list(args.seeds)]
    return sweep(cells, args, device)


if __name__ == "__main__":
    main()
