"""Meta-overfitting study: sweep n_train_tasks x weight_decay x seeds for
PACOH-MAP (or MAML / the NP), results accumulating in a CSV (counterpart of
experiments/meta_overfitting/run_overfitting_sweep.py).

    python -m meta_learning_pacoh_torch.experiments.meta_overfitting.run_overfitting_sweep [--flag value ...]

The protocol is the original's: each meta-train task comes as a (context,
test) 4-tuple, the contexts train the prior, and both the held-out points of
the training tasks (*_meta_train) and fresh tasks (*_meta_test) are
evaluated. ``--seed_parallel`` fits all seeds of one (n_tasks, weight decay)
cell through ``parallel.fit_models_parallel`` (its default ``prefer``). As
in the original, a cell that raises becomes a NaN row ("FAILED ..."), and a
seed group that raises falls back to sequential runs ("seed-parallel FAILED
..."); ``main`` also returns how many of each happened.
"""

import math
import time

from meta_learning_pacoh_torch.datasets import provide_data
from meta_learning_pacoh_torch.experiments._cli import FlagParser, Outcome, int_list, write_csv

NAN_METRICS = {k: math.nan for k in (
    "test_rmse_meta_train", "test_rmse_meta_test",
    "test_ll_meta_train", "test_ll_meta_test", "calib_err")}


def parser():
    p = FlagParser(__doc__.splitlines()[0])
    p.string("dataset", "sin", "dataset family (sin | cauchy | ...)")
    p.string("algo", "pacoh_map", "pacoh_map | maml | np")
    p.string("n_tasks_grid", "2,4,8,16,32,64,128,256,512", "task counts")
    p.string("weight_decay_grid", "0.0,0.1,0.2,0.5,1.0", "weight decays")
    p.string("seeds", "22,23,24,25,26", "seeds")
    p.integer("n_iter_fit", 10000, "meta-train iterations")
    p.integer("n_test_tasks", 50, "test tasks")
    p.string("output_csv", "./meta_overfitting.csv", "output CSV")
    p.boolean("seed_parallel", False,
              "fit all seeds of one (n_tasks, wd) cell at once through "
              "parallel.fit_models_parallel instead of one after another")
    return p


def build_one(algo, dataset, n_tasks, weight_decay, seed, n_iter, n_test, device=None):
    """The learner of one cell, its meta-train 4-tuples and its test tasks."""
    from meta_learning_pacoh_torch import (
        GPRegressionMetaLearned,
        MAMLRegression,
        NPRegressionMetaLearned,
    )

    _, valid, test = provide_data(f"{dataset}_{n_tasks}", seed=seed)
    meta_train_tuples = valid[:n_tasks]  # 4-tuples; contexts train the prior
    train = [(cx, cy) for cx, cy, _, _ in meta_train_tuples]
    test = test[:n_test]
    if algo == "pacoh_map":
        m = GPRegressionMetaLearned(train, weight_decay=weight_decay, num_iter_fit=n_iter,
                                    random_seed=seed, device=device)
    elif algo == "np":
        m = NPRegressionMetaLearned(train, weight_decay=weight_decay, num_iter_fit=n_iter,
                                    random_seed=seed, device=device)
    elif algo == "maml":
        m = MAMLRegression(train, num_iter_fit=n_iter, random_seed=seed, device=device)
    else:
        raise ValueError(algo)
    return m, meta_train_tuples, test


def eval_one(algo, m, meta_train_tuples, test):
    if algo == "maml":
        return {"test_rmse_meta_train": m.eval_datasets(meta_train_tuples),
                "test_rmse_meta_test": m.eval_datasets(test),
                "test_ll_meta_train": math.nan, "test_ll_meta_test": math.nan,
                "calib_err": math.nan}
    ll_tr, rmse_tr, _ = m.eval_datasets(meta_train_tuples)
    ll_te, rmse_te, calib = m.eval_datasets(test)
    return {"test_rmse_meta_train": rmse_tr, "test_rmse_meta_test": rmse_te,
            "test_ll_meta_train": ll_tr, "test_ll_meta_test": ll_te,
            "calib_err": calib}


def run_one(algo, dataset, n_tasks, weight_decay, seed, n_iter, n_test, device=None):
    m, meta_train_tuples, test = build_one(algo, dataset, n_tasks, weight_decay, seed, n_iter,
                                           n_test, device)
    m.meta_fit(verbose=False, log_period=n_iter)
    return eval_one(algo, m, meta_train_tuples, test)


def run_seed_group(algo, dataset, n_tasks, weight_decay, seeds, n_iter, n_test, device=None):
    """All seeds of one grid cell fitted together by fit_models_parallel."""
    from meta_learning_pacoh_torch.parallel import fit_models_parallel

    built = [build_one(algo, dataset, n_tasks, weight_decay, s, n_iter, n_test, device)
             for s in seeds]
    fit_models_parallel([m for m, _, _ in built], n_iter=n_iter)
    return [eval_one(algo, m, tr, te) for m, tr, te in built]


def main(argv=None, device=None):
    """Run the sweep of the command line ``argv`` (None: ``sys.argv[1:]``) on
    ``device`` (None: the card); returns its Outcome."""
    args = parser().parse(argv)
    rows, failed, fell_back = [], 0, 0
    seeds = int_list(args.seeds)
    for n_tasks in int_list(args.n_tasks_grid):
        for wd in (float(s) for s in args.weight_decay_grid.split(",")):
            t0 = time.time()
            per_seed = None
            if args.seed_parallel:
                try:
                    per_seed = run_seed_group(args.algo, args.dataset, n_tasks, wd, seeds,
                                              args.n_iter_fit, args.n_test_tasks, device)
                except Exception as e:  # the original's fallback to sequential runs
                    print(f"seed-parallel FAILED n_tasks={n_tasks} wd={wd}: "
                          f"{e!r}; falling back to sequential")
                    fell_back += 1
            # With the seeds fitted together, each row's duration is the
            # group's wall-clock over the seeds (t0 is not reset in the loop
            # then); sequential rows time their own run.
            group_duration = (time.time() - t0) / len(seeds) if per_seed is not None else None
            for i, seed in enumerate(seeds):
                if per_seed is not None:
                    metrics = per_seed[i]
                else:
                    try:
                        metrics = run_one(args.algo, args.dataset, n_tasks, wd, seed,
                                          args.n_iter_fit, args.n_test_tasks, device)
                    except Exception as e:
                        print(f"FAILED n_tasks={n_tasks} wd={wd} seed={seed}: {e!r}")
                        metrics = dict(NAN_METRICS)
                        failed += 1
                rows.append({
                    "algo": args.algo, "dataset": args.dataset,
                    "n_tasks": n_tasks, "weight_decay": wd, "seed": seed,
                    **metrics,
                    "duration": (group_duration if group_duration is not None
                                 else time.time() - t0),
                })
                if group_duration is None:
                    t0 = time.time()
                print(rows[-1])
                write_csv(rows, args.output_csv)
    return Outcome(rows, failed, fell_back)


if __name__ == "__main__":
    main()
