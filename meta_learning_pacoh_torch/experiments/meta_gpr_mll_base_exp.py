"""PACOH-MAP experiment CLI (counterpart of experiments/meta_gpr_mll_base_exp.py).

    python -m meta_learning_pacoh_torch.experiments.meta_gpr_mll_base_exp [--flag value ...]
"""

import functools

from meta_learning_pacoh_torch import GPRegressionMetaLearned
from meta_learning_pacoh_torch.experiments.meta_base_exp import (
    base_parser,
    nn_layers,
    run_experiment,
)

EXTRA_FLAGS = ("weight_decay", "learning_mode")


def parser():
    p = base_parser(__doc__.splitlines()[0])
    p.real("weight_decay", 0.0, "AdamW weight decay (meta-regularization)")
    p.string("learning_mode", "both", "learn_mean | learn_kernel | both | vanilla")
    return p


def build_model(args, meta_train_data, device=None):
    return GPRegressionMetaLearned(
        meta_train_data,
        learning_mode=args.learning_mode,
        lr_params=args.lr,
        weight_decay=args.weight_decay,
        feature_dim=args.feature_dim,
        num_iter_fit=args.n_iter_fit,
        covar_module=args.covar_module,
        mean_module=args.mean_module,
        mean_nn_layers=nn_layers(args),
        kernel_nn_layers=nn_layers(args),
        task_batch_size=args.task_batch_size,
        normalize_data=args.normalize_data,
        lr_decay=args.lr_decay,
        random_seed=args.seed,
        device=device,
    )


def main(argv=None, device=None):
    """Run the experiment of the command line ``argv`` (None: ``sys.argv[1:]``)
    on ``device`` (None: the card); returns its results dict."""
    args = parser().parse(argv)
    return run_experiment("meta_gpr_mll", functools.partial(build_model, args), args,
                          EXTRA_FLAGS, device)


if __name__ == "__main__":
    main()
