"""Neural Process experiment CLI (counterpart of experiments/npr_base_exp.py).

    python -m meta_learning_pacoh_torch.experiments.npr_base_exp [--flag value ...]
"""

import functools

from meta_learning_pacoh_torch import NPRegressionMetaLearned
from meta_learning_pacoh_torch.experiments.meta_base_exp import base_parser, run_experiment

EXTRA_FLAGS = ("weight_decay", "r_dim", "z_dim", "h_dim")


def parser():
    p = base_parser(__doc__.splitlines()[0])
    p.real("weight_decay", 1e-2, "AdamW weight decay")
    p.integer("r_dim", 50, "context representation dim")
    p.integer("z_dim", 50, "latent dim")
    p.integer("h_dim", 50, "hidden width")
    return p


def build_model(args, meta_train_data, device=None):
    return NPRegressionMetaLearned(
        meta_train_data,
        lr_params=args.lr,
        r_dim=args.r_dim, z_dim=args.z_dim, h_dim=args.h_dim,
        num_iter_fit=args.n_iter_fit,
        weight_decay=args.weight_decay,
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
    return run_experiment("npr", functools.partial(build_model, args), args, EXTRA_FLAGS,
                          device)


if __name__ == "__main__":
    main()
