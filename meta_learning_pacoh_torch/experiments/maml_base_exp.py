"""MAML experiment CLI (counterpart of experiments/maml_base_exp.py).

    python -m meta_learning_pacoh_torch.experiments.maml_base_exp [--flag value ...]

As the original: the run directory hashes nine of the flags, the fit takes
the learner's own ``num_iter_fit`` steps, and results.json holds the test
RMSE and the seconds of the fit and the evaluation together.
"""

import time

from meta_learning_pacoh_torch import MAMLRegression
from meta_learning_pacoh_torch.experiments.meta_base_exp import base_parser, load_data, nn_layers
from meta_learning_pacoh_torch.utils.experiment import save_results, setup_exp_doc

HASHED_FLAGS = ("dataset", "seed", "n_iter_fit", "nn_layers", "lr", "lr_decay",
                "task_batch_size", "lr_inner", "num_inner_steps")


def parser():
    p = base_parser(__doc__.splitlines()[0])
    p.real("lr_inner", 0.05, "inner-loop learning rate")
    p.integer("num_inner_steps", 1, "inner adaptation steps")
    return p


def build_model(args, meta_train_data, device=None):
    return MAMLRegression(
        meta_train_data, layer_sizes=nn_layers(args), num_iter_fit=args.n_iter_fit,
        lr_inner=args.lr_inner, num_inner_steps=args.num_inner_steps,
        task_batch_size=args.task_batch_size, lr_meta=args.lr,
        lr_decay=args.lr_decay, random_seed=args.seed, device=device,
    )


def main(argv=None, device=None):
    """Run the experiment of the command line ``argv`` (None: ``sys.argv[1:]``)
    on ``device`` (None: the card); returns its results dict."""
    args = parser().parse(argv)
    flags_dict = {k: getattr(args, k) for k in HASHED_FLAGS}
    run_dir = setup_exp_doc("maml", flags_dict, args.data_dir)
    data_train, data_valid, data_test = load_data(args)
    model = build_model(args, data_train, device)
    t0 = time.time()
    model.meta_fit(valid_tuples=data_valid[:10], log_period=args.log_period)
    rmse = model.eval_datasets(data_test)
    results = {"test_rmse": rmse, "fit_time_sec": time.time() - t0}
    save_results(results, run_dir)
    print(f"maml: RMSE={rmse:.4f}")
    return results


if __name__ == "__main__":
    main()
