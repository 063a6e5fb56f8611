"""Shared flags and runner of the per-algorithm experiment CLIs (counterpart
of experiments/meta_base_exp.py).

``base_parser`` defines the original's 15 flags (experiments/meta_base_exp.py:22-36)
with their names, defaults and types; ``run_experiment`` builds the dataset
from the registry, the learner, meta-fits it, evaluates it on the test split
and writes config.json + results.json into the run directory named by the
md5 of the same flag dict as the original's (``utils.experiment.setup_exp_doc``).
"""

import time

from meta_learning_pacoh_torch.datasets import provide_data
from meta_learning_pacoh_torch.experiments._cli import FlagParser
from meta_learning_pacoh_torch.utils.experiment import save_results, setup_exp_doc

BASE_FLAGS = (
    "dataset", "seed", "n_iter_fit", "n_train_tasks", "n_train_samples",
    "mean_module", "covar_module", "feature_dim", "nn_layers", "lr",
    "lr_decay", "task_batch_size", "normalize_data",
)


def base_parser(description):
    """A parser holding the original's shared flags; each CLI adds its own."""
    p = FlagParser(description)
    p.string("dataset", "sin_20", "dataset registry string")
    p.integer("seed", 28, "random seed")
    p.integer("n_iter_fit", 10000, "number of meta-training iterations")
    p.integer("n_train_tasks", -1, "override number of train tasks (-1 = default)")
    p.integer("n_train_samples", -1, "override samples per task (-1 = default)")
    p.string("mean_module", "NN", "mean module: NN | constant | zero")
    p.string("covar_module", "NN", "covar module: NN | SE")
    p.integer("feature_dim", 2, "kernel NN feature dim")
    p.string("nn_layers", "32,32", "hidden layer sizes, comma-separated")
    p.real("lr", 1e-3, "learning rate")
    p.real("lr_decay", 1.0, "multiplicative lr decay per 1000 steps")
    p.integer("task_batch_size", 5, "tasks per meta-gradient step")
    p.integer("log_period", 1000, "steps between log lines")
    p.string("data_dir", "./exp_results", "output directory")
    p.boolean("normalize_data", True, "z-score normalization")
    return p


def nn_layers(args):
    return tuple(int(s) for s in args.nn_layers.split(","))


def load_data(args):
    n_tasks = None if args.n_train_tasks < 0 else args.n_train_tasks
    n_samples = None if args.n_train_samples < 0 else args.n_train_samples
    return provide_data(args.dataset, seed=args.seed, n_train_tasks=n_tasks,
                        n_samples=n_samples)


def run_experiment(exp_name, build_model, args, extra_flags=(), device=None):
    """build_model(meta_train_data, device) -> learner with meta_fit /
    eval_datasets; ``device`` None means the card. Returns the results dict
    written to results.json."""
    flags_dict = {name: getattr(args, name) for name in (*BASE_FLAGS, *extra_flags)}
    run_dir = setup_exp_doc(exp_name, flags_dict, args.data_dir)

    data_train, data_valid, data_test = load_data(args)
    model = build_model(data_train, device)

    t0 = time.time()
    model.meta_fit(valid_tuples=data_valid[:10], log_period=args.log_period,
                   n_iter=args.n_iter_fit)
    fit_time = time.time() - t0

    t0 = time.time()
    test_ll, test_rmse, calib_err = model.eval_datasets(data_test)
    eval_time = time.time() - t0

    results = {
        "test_ll": test_ll,
        "test_rmse": test_rmse,
        "calib_err": calib_err,
        "fit_time_sec": fit_time,
        "eval_time_sec": eval_time,
    }
    save_results(results, run_dir)
    print(f"{exp_name}: LL={test_ll:.4f} RMSE={test_rmse:.4f} calib={calib_err:.4f}")
    return results
