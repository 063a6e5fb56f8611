"""TPE hyperparameter search per algorithm, then a seeded re-evaluation of
the top configs (counterpart of
experiments/hyperparam_search/meta_hyperparam_search.py).

    python -m meta_learning_pacoh_torch.experiments.hyperparam_search.meta_hyperparam_search [--flag value ...]

The search runs through ``utils.tuning.tune_run`` (``--resume`` continues
from its experiment state); ``--trial_batch_size`` k > 1 runs the trials in
batches of k through ``utils.tuning_parallel.run_trial_batch`` (trials that
agree on ``BATCH_STATIC_KEYS`` fitted together, for MAP, SVGD and VI); and
``--seed_parallel`` fits the re-evaluation seeds of each top config through
``parallel.fit_models_parallel``. The rows go to
``<local_dir>/best_configs_<algo>_<dataset>.csv``, and the mean and std of
each rank's metrics are printed. As in ``tune_run``, a trial that raises is
recorded as failed and a batch that raises falls back to sequential trials;
``main`` also returns how many of each happened.
"""

import os

from meta_learning_pacoh_torch.datasets import provide_data
from meta_learning_pacoh_torch.experiments._cli import (
    FlagParser,
    Outcome,
    format_table,
    group_stats,
    write_csv,
)
from meta_learning_pacoh_torch.utils.tuning import (
    Choice,
    LogUniform,
    Uniform,
    select_best_configs,
    tune_run,
)

METRICS = ("test_ll", "test_rmse", "calib_err")

# config keys that change tensor shapes or the step's structure: trials are
# only fitted together within a group that agrees on all of them
BATCH_STATIC_KEYS = {
    "pacoh_map": ("feature_dim", "task_batch_size"),
    "pacoh_svgd": ("num_particles",),
    "pacoh_vi": ("svi_batch_size",),
}


def parser():
    p = FlagParser(__doc__.splitlines()[0])
    p.string("algo", "pacoh_map", "pacoh_map | pacoh_svgd | pacoh_vi | pacoh_mlap")
    p.string("dataset", "sin_20", "dataset key")
    p.integer("num_samples", 40, "number of TPE trials")
    p.integer("n_iter_fit", 10000, "meta-train iterations per trial")
    p.integer("n_eval_tasks", 40, "validation tasks per trial")
    p.integer("n_test_seeds", 5, "seeds for final re-evaluation")
    p.integer("top_n", 5, "top configs to re-evaluate")
    p.string("local_dir", "./tune_out", "tuning state directory")
    p.boolean("resume", False, "resume from experiment state")
    p.boolean("seed_parallel", False,
              "fit the re-evaluation seeds of each top config together "
              "(parallel.fit_models_parallel) instead of one after another")
    p.integer("trial_batch_size", 1,
              "run TPE trials in batches of this size: configs that agree on "
              "BATCH_STATIC_KEYS are fitted together over their continuous "
              "hyperparameters, lr/weight_decay (pacoh_map), lr/prior_factor/"
              "bandwidth (pacoh_svgd), lr/prior_factor (pacoh_vi) "
              "(utils/tuning_parallel.py; other algos run each batch sequentially)")
    return p


def search_space(algo):
    if algo == "pacoh_map":
        return {
            "lr": LogUniform(5e-4, 5e-3),
            "weight_decay": LogUniform(1e-3, 1.0),
            "feature_dim": Choice([2, 4, 8]),
            "task_batch_size": Choice([4, 10, 20]),
        }
    if algo == "pacoh_svgd":
        return {
            "lr": LogUniform(5e-4, 5e-3),
            "prior_factor": LogUniform(1e-4, 1e-1),
            "bandwidth": Uniform(0.1, 10.0),
            "num_particles": Choice([5, 10]),
        }
    if algo == "pacoh_vi":
        return {
            "lr": LogUniform(5e-4, 5e-3),
            "prior_factor": LogUniform(1e-4, 1e-1),
            "svi_batch_size": Choice([5, 10]),
        }
    if algo == "pacoh_mlap":
        return {
            "task_kl_weight": LogUniform(5e-2, 1.0),
            "meta_kl_weight": LogUniform(1e-7, 1.0),
            "lr": LogUniform(1e-4, 1e-3),
            "lr_decay": LogUniform(0.92, 0.97),
            "posterior_lr_multiplier": LogUniform(1.0, 10.0),
            "svi_batch_size": Choice([5, 10]),
            "task_batch_size": Choice([5, 20]),
        }
    raise ValueError(algo)


def build_model(algo, config, dataset, seed, n_iter, device=None):
    from meta_learning_pacoh_torch import (
        GPRegressionMetaLearned,
        GPRegressionMetaLearnedPAC,
        GPRegressionMetaLearnedSVGD,
        GPRegressionMetaLearnedVI,
    )

    train, valid, test = provide_data(dataset, seed=seed)
    if algo == "pacoh_map":
        model = GPRegressionMetaLearned(
            train, lr_params=config["lr"], weight_decay=config["weight_decay"],
            feature_dim=int(config["feature_dim"]),
            task_batch_size=int(config["task_batch_size"]),
            num_iter_fit=n_iter, random_seed=seed, device=device,
        )
    elif algo == "pacoh_svgd":
        model = GPRegressionMetaLearnedSVGD(
            train, lr=config["lr"], prior_factor=config["prior_factor"],
            bandwidth=config["bandwidth"], num_particles=int(config["num_particles"]),
            num_iter_fit=n_iter, random_seed=seed, device=device,
        )
    elif algo == "pacoh_vi":
        model = GPRegressionMetaLearnedVI(
            train, lr=config["lr"], prior_factor=config["prior_factor"],
            svi_batch_size=int(config["svi_batch_size"]),
            num_iter_fit=n_iter, random_seed=seed, device=device,
        )
    elif algo == "pacoh_mlap":
        model = GPRegressionMetaLearnedPAC(
            train, lr=config["lr"], lr_decay=config["lr_decay"],
            task_kl_weight=config["task_kl_weight"],
            meta_kl_weight=config["meta_kl_weight"],
            posterior_lr_multiplier=config["posterior_lr_multiplier"],
            svi_batch_size=int(config["svi_batch_size"]),
            task_batch_size=int(config["task_batch_size"]),
            mean_module="NN", covar_module="NN",
            num_iter_fit=n_iter, random_seed=seed, device=device,
        )
    else:
        raise ValueError(algo)
    return model, test


def evaluate(model, test, n_eval_tasks):
    ll, rmse, calib = model.eval_datasets(test[:n_eval_tasks])
    return {"test_ll": ll, "test_rmse": rmse, "calib_err": calib}


def build_and_eval(algo, config, dataset, seed, n_iter, n_eval_tasks, device=None):
    model, test = build_model(algo, config, dataset, seed, n_iter, device)
    model.meta_fit(verbose=False, log_period=n_iter)
    return evaluate(model, test, n_eval_tasks)


def eval_config_over_seeds_parallel(algo, config, dataset, seeds, n_iter, n_eval_tasks,
                                    device=None):
    """All re-evaluation seeds of a config fitted together by fit_models_parallel."""
    from meta_learning_pacoh_torch.parallel import fit_models_parallel

    built = [build_model(algo, config, dataset, s, n_iter, device) for s in seeds]
    fit_models_parallel([m for m, _ in built], n_iter=n_iter)
    return [evaluate(model, test, n_eval_tasks) for model, test in built]


def batch_trial_fn(algo, dataset, n_iter, n_eval_tasks, device=None, calls=None):
    """tune_run's batch_trial_fn: the batch through run_trial_batch, each model
    evaluated on its own test split. ``calls`` (a dict) counts the batches
    started and finished."""
    from meta_learning_pacoh_torch.utils.tuning_parallel import run_trial_batch

    calls = {} if calls is None else calls

    def batch_trial(configs):
        calls["started"] = calls.get("started", 0) + 1
        tests = {}

        def build(config):
            model, test = build_model(algo, config, dataset, seed=28, n_iter=n_iter,
                                      device=device)
            tests[id(model)] = test
            return model

        out = run_trial_batch(configs, build, lambda m: evaluate(m, tests[id(m)], n_eval_tasks),
                              n_iter=n_iter, static_keys=BATCH_STATIC_KEYS[algo])
        calls["finished"] = calls.get("finished", 0) + 1
        return out

    return batch_trial


def summary_table(rows):
    """The mean and std of each rank's metrics (the original's
    ``df.groupby("rank")[metrics].agg(["mean", "std"])``)."""
    aggs = {(m, f): (m, f) for m in METRICS for f in ("mean", "std")}
    return group_stats(rows, ["rank"], aggs)


def main(argv=None, device=None):
    """Run the search of the command line ``argv`` (None: ``sys.argv[1:]``) on
    ``device`` (None: the card); returns its Outcome (failed: trials
    recorded as failed; fell_back: batches rerun as sequential trials)."""
    args = parser().parse(argv)
    algo, dataset = args.algo, args.dataset

    def trial(config):
        return build_and_eval(algo, config, dataset, seed=28, n_iter=args.n_iter_fit,
                              n_eval_tasks=args.n_eval_tasks, device=device)

    calls = {}
    batch_trial = None
    if args.trial_batch_size > 1 and algo in BATCH_STATIC_KEYS:
        batch_trial = batch_trial_fn(algo, dataset, args.n_iter_fit, args.n_eval_tasks,
                                     device, calls)

    analysis = tune_run(
        trial, search_space(algo), num_samples=args.num_samples,
        metric="test_ll", mode="max", local_dir=args.local_dir,
        name=f"{algo}_{dataset}", resume=args.resume,
        batch_size=args.trial_batch_size, batch_trial_fn=batch_trial,
    )

    best = select_best_configs(analysis, metric="test_ll", N=args.top_n)
    print("top configs:", best)

    rows = []
    seeds = list(range(31, 31 + args.n_test_seeds))
    for rank, config in enumerate(best):
        if args.seed_parallel:
            per_seed = eval_config_over_seeds_parallel(
                algo, config, dataset, seeds, n_iter=args.n_iter_fit,
                n_eval_tasks=args.n_eval_tasks, device=device)
        else:
            per_seed = [build_and_eval(algo, config, dataset, seed=s, n_iter=args.n_iter_fit,
                                       n_eval_tasks=args.n_eval_tasks, device=device)
                        for s in seeds]
        for seed, metrics in zip(seeds, per_seed):
            rows.append({"rank": rank, "seed": seed, **config, **metrics})
            print(rows[-1])
    out = os.path.join(args.local_dir, f"best_configs_{algo}_{dataset}.csv")
    write_csv(rows, out)
    print(format_table(["rank"], [[m for m in METRICS for _ in (0, 1)],
                                  ["mean", "std"] * len(METRICS)],
                       [(key, list(vals.values())) for key, vals in summary_table(rows)]))
    failed = sum(1 for t in analysis.trials if t["status"] == "ERROR")
    return Outcome(rows, failed, calls.get("started", 0) - calls.get("finished", 0))


if __name__ == "__main__":
    main()
