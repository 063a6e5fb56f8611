"""Generate (and optionally execute) the hyperparameter-search commands for a
grid of datasets x algorithms (counterpart of
experiments/hyperparam_search/launch_hyperparam_sweeps.py).

    python -m meta_learning_pacoh_torch.experiments.hyperparam_search.launch_hyperparam_sweeps [--flag value ...]

Each command runs the port's search,
``python -m meta_learning_pacoh_torch.experiments.hyperparam_search.meta_hyperparam_search``,
with ``--dataset`` and ``--algo``; ``--execute`` runs them one after another.
"""

import os

from meta_learning_pacoh_torch.experiments._cli import FlagParser
from meta_learning_pacoh_torch.utils.experiment import generate_launch_commands

SEARCH_MODULE = "meta_learning_pacoh_torch.experiments.hyperparam_search.meta_hyperparam_search"


def parser():
    p = FlagParser(__doc__.splitlines()[0])
    p.string("datasets", "sin_20,cauchy_20", "datasets to sweep")
    p.string("algos", "pacoh_map,pacoh_svgd,pacoh_vi", "algorithms")
    p.boolean("execute", False, "run the commands instead of printing")
    return p


def main(argv=None, device=None):
    """Print (and with --execute run) the commands of the command line
    ``argv`` (None: ``sys.argv[1:]``); returns them. The commands run on the
    card, as the search does by default; ``device`` is not passed on."""
    args = parser().parse(argv)
    commands = generate_launch_commands(f"-m {SEARCH_MODULE}", {
        "dataset": args.datasets.split(","),
        "algo": args.algos.split(","),
    })
    for cmd in commands:
        print(cmd)
        if args.execute:
            os.system(cmd)
    return commands


if __name__ == "__main__":
    main()
