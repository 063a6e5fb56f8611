"""Visualize sampled tasks from the simulated meta-learning environments
(counterpart of experiments/visualization_tasks/visualize_sim_tasks.py).

    python -m meta_learning_pacoh_torch.experiments.visualization_tasks.visualize_sim_tasks [--envs sin,cauchy] [--n_tasks 5] [--n_samples 50] [--output sim_tasks.png]

For each environment key it samples ``--n_tasks`` meta-train tasks of
``--n_samples`` points from the port's environment seeded with
``np.random.RandomState(--seed)`` and draws each task's points as a line
sorted by the first input and as a scatter, one panel an environment. No
learner is trained and nothing runs on a device. matplotlib is imported
inside ``main`` only, as in the original: where it is missing, ``main``
fails on that import.
"""

import numpy as np

from meta_learning_pacoh_torch.datasets import (
    CauchyDataset,
    GPFunctionsDataset,
    SinusoidDataset,
    SinusoidNonstationaryDataset,
)
from meta_learning_pacoh_torch.experiments._cli import FlagParser

ENVS = {
    "sin": SinusoidDataset,
    "cauchy": CauchyDataset,
    "mixture": SinusoidNonstationaryDataset,
    "gp_funcs": GPFunctionsDataset,
}


def parser():
    p = FlagParser(__doc__.splitlines()[0])
    p.string("envs", "sin,cauchy,mixture", "comma-separated environment keys "
             "(sin | cauchy | mixture)")
    p.integer("n_tasks", 5, "tasks sampled per environment")
    p.integer("n_samples", 40, "training points sampled per task")
    p.integer("seed", 26, "environment RNG seed")
    p.string("output", "./sim_tasks.png", "output image")
    return p


def make_env(key, rs):
    return ENVS[key](random_state=rs)


def sample_tasks(key, n_tasks, n_samples, seed):
    """The meta-train tasks [(x [n, d], y [n, 1])] drawn for environment ``key``."""
    env = make_env(key, np.random.RandomState(seed))
    return env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)


def main(argv=None):
    """Draw the figure of the command line (``argv`` None: ``sys.argv[1:]``);
    returns {environment key: its tasks}."""
    args = parser().parse(argv)
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    keys = args.envs.split(",")
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3.2), squeeze=False)
    out = {}
    for ax, key in zip(axes[0], keys):
        tasks = out[key] = sample_tasks(key, args.n_tasks, args.n_samples, args.seed)
        for i, (x, y) in enumerate(tasks):
            order = np.argsort(x[:, 0])
            color = plt.get_cmap("tab10")(i % 10)
            ax.plot(x[order, 0], y[order].ravel(), lw=1.0, color=color, alpha=0.8)
            ax.scatter(x[:, 0], y.ravel(), s=6, color=color, alpha=0.5)
        ax.set_title(key)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
    fig.tight_layout()
    fig.savefig(args.output, dpi=150)
    print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
