"""PACOH-MLAP experiment CLI (counterpart of experiments/meta_mlap_base_exp.py).

    python -m meta_learning_pacoh_torch.experiments.meta_mlap_base_exp [--flag value ...]

``--n_iter_meta_test`` is defined as the original defines it, and, as there,
no call reads it: the evaluation takes the learner's own meta-test length
(``eval_datasets``' default, 3000 steps), so one command line gives the
same results on both.
"""

import functools

from meta_learning_pacoh_torch import GPRegressionMetaLearnedPAC
from meta_learning_pacoh_torch.experiments.meta_base_exp import (
    base_parser,
    nn_layers,
    run_experiment,
)

EXTRA_FLAGS = ("task_kl_weight", "meta_kl_weight", "posterior_lr_multiplier", "svi_batch_size",
               "cov_type")


def parser():
    p = base_parser(__doc__.splitlines()[0])
    p.real("task_kl_weight", 1.0, "inner-KL weight")
    p.real("meta_kl_weight", 1e-5, "outer-KL weight")
    p.real("posterior_lr_multiplier", 5.0, "task-posterior lr multiplier")
    p.integer("svi_batch_size", 5, "hyper-posterior samples per step")
    p.string("cov_type", "diag", "hyper-posterior covariance: diag | full")
    p.integer("n_iter_meta_test", 3000, "per-task meta-test Adam steps")
    return p


def build_model(args, meta_train_data, device=None):
    return GPRegressionMetaLearnedPAC(
        meta_train_data,
        num_iter_fit=args.n_iter_fit,
        feature_dim=args.feature_dim,
        task_kl_weight=args.task_kl_weight,
        meta_kl_weight=args.meta_kl_weight,
        posterior_lr_multiplier=args.posterior_lr_multiplier,
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
    return run_experiment("meta_mlap", functools.partial(build_model, args), args,
                          EXTRA_FLAGS, device)


if __name__ == "__main__":
    main()
