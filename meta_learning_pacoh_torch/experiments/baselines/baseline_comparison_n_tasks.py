"""Baseline comparison swept over the number of meta-train tasks (counterpart
of experiments/baselines/baseline_comparison_n_tasks.py).

    python -m meta_learning_pacoh_torch.experiments.baselines.baseline_comparison_n_tasks [--flag value ...]

Datasets {family}_{n} for each n of ``--n_tasks_grid`` and each family of
``--base_datasets``; one CSV row per (dataset, algo, seed) cell. It takes
baseline_comparison's flags, with ``output_csv`` defaulting to
./baseline_comparison_n_tasks.csv, and records failures as it does.
"""

from meta_learning_pacoh_torch.experiments._cli import FlagParser, int_list
from meta_learning_pacoh_torch.experiments.baselines.baseline_comparison import add_flags, sweep


def parser():
    p = add_flags(FlagParser(__doc__.splitlines()[0]))
    p.string("base_datasets", "sin,cauchy", "dataset families to sweep")
    p.string("n_tasks_grid", "5,10,20,40,80,160,320", "comma-separated n_train_tasks values")
    p.set_default("output_csv", "./baseline_comparison_n_tasks.csv")
    return p


def main(argv=None, device=None):
    """Run the sweep of the command line ``argv`` (None: ``sys.argv[1:]``) on
    ``device`` (None: the card); returns its Outcome."""
    args = parser().parse(argv)
    datasets = [f"{family}_{n}" for n in int_list(args.n_tasks_grid)
                for family in args.base_datasets.split(",")]
    cells = [({"algo": algo, "dataset": dataset, "n_train_tasks": int(dataset.split("_")[-1]),
               "seed": seed}, algo, dataset, seed)
             for dataset in datasets
             for algo in args.algos.split(",")
             for seed in int_list(args.seeds)]
    return sweep(cells, args, device)


if __name__ == "__main__":
    main()
