"""PACOH-VI experiment CLI (counterpart of experiments/meta_gpr_vi_base_exp.py).

    python -m meta_learning_pacoh_torch.experiments.meta_gpr_vi_base_exp [--flag value ...]
"""

import functools

from meta_learning_pacoh_torch import GPRegressionMetaLearnedVI
from meta_learning_pacoh_torch.experiments.meta_base_exp import (
    base_parser,
    nn_layers,
    run_experiment,
)

EXTRA_FLAGS = ("prior_factor", "weight_prior_std", "bias_prior_std", "svi_batch_size",
               "cov_type")


def parser():
    p = base_parser(__doc__.splitlines()[0])
    p.real("prior_factor", 0.01, "hyper-prior weighting")
    p.real("weight_prior_std", 0.5, "hyper-prior std on NN weights")
    p.real("bias_prior_std", 3.0, "hyper-prior std on NN biases")
    p.integer("svi_batch_size", 10, "reparameterized samples per step")
    p.string("cov_type", "diag", "posterior covariance: diag | full")
    return p


def build_model(args, meta_train_data, device=None):
    return GPRegressionMetaLearnedVI(
        meta_train_data,
        num_iter_fit=args.n_iter_fit,
        feature_dim=args.feature_dim,
        prior_factor=args.prior_factor,
        weight_prior_std=args.weight_prior_std,
        bias_prior_std=args.bias_prior_std,
        covar_module=args.covar_module,
        mean_module=args.mean_module,
        mean_nn_layers=nn_layers(args),
        kernel_nn_layers=nn_layers(args),
        lr=args.lr,
        lr_decay=args.lr_decay,
        svi_batch_size=args.svi_batch_size,
        cov_type=args.cov_type,
        task_batch_size=args.task_batch_size,
        normalize_data=args.normalize_data,
        random_seed=args.seed,
        device=device,
    )


def main(argv=None, device=None):
    """Run the experiment of the command line ``argv`` (None: ``sys.argv[1:]``)
    on ``device`` (None: the card); returns its results dict."""
    args = parser().parse(argv)
    return run_experiment("meta_gpr_vi", functools.partial(build_model, args), args,
                          EXTRA_FLAGS, device)


if __name__ == "__main__":
    main()
