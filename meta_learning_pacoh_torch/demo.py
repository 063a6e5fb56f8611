"""PACOH-MAP demo on the port (counterpart of demo.py): meta-train on 20
sinusoid tasks, meta-test, report LL/RMSE/calibration, and plot one task's
prediction.

    python -m meta_learning_pacoh_torch.demo

The same data, seeds and 12,000 steps as the reference demo, on the card.
The plot needs matplotlib; without it the demo says it could not plot, as
the reference does. The prediction and the confidence intervals are computed
before that, so an error in them is raised, not reported as a plot failure.
"""

import argparse
import sys

import numpy as np

NUM_ITER_FIT = 12000
LOG_PERIOD = 1000


def main(argv=None, device=None):
    """Run the demo on ``device`` (None: the card); it takes no arguments.
    Returns (LL, RMSE, calibration error) of the meta-test."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        sys.argv[1:] if argv is None else argv)

    from meta_learning_pacoh_torch import GPRegressionMetaLearned
    from meta_learning_pacoh_torch.datasets import SinusoidDataset

    # generate meta-training and meta-testing data
    random_state = np.random.RandomState(26)
    task_environment = SinusoidDataset(random_state=random_state)
    meta_train_data = task_environment.generate_meta_train_data(n_tasks=20, n_samples=5)
    meta_test_data = task_environment.generate_meta_test_data(
        n_tasks=20, n_samples_context=5, n_samples_test=50
    )

    # meta-training with PACOH-MAP
    random_gp = GPRegressionMetaLearned(
        meta_train_data, weight_decay=0.2, num_iter_fit=NUM_ITER_FIT, random_seed=30,
        device=device,
    )
    random_gp.meta_fit(meta_test_data, log_period=LOG_PERIOD)

    # meta-testing
    print("\n")
    ll, rmse, calib_err = random_gp.eval_datasets(meta_test_data)
    print("Test log-likelihood:", ll)
    print("Test RMSE:", rmse)
    print("Test calibration error:", calib_err)

    x_plot = np.linspace(-5, 5, num=150)
    x_context, y_context, x_test, y_test = meta_test_data[0]
    pred_mean, pred_std = random_gp.predict(x_context, y_context, x_plot)
    ucb, lcb = random_gp.confidence_intervals(x_context, y_context, x_plot, confidence=0.9)
    try:
        from matplotlib import pyplot as plt

        plt.scatter(x_test, y_test, label="target test points")
        plt.scatter(x_context, y_context, label="target context points")
        plt.plot(x_plot, pred_mean)
        plt.fill_between(x_plot, lcb, ucb, alpha=0.2, label="90% confidence interval")
        plt.legend()
        plt.title("meta-testing prediction on new target task")
        plt.savefig("demo_prediction.png", dpi=120)
        print("saved plot to demo_prediction.png")
    except Exception as e:
        print(f"\n Could not plot results ({e!r}).")
    return ll, rmse, calib_err


if __name__ == "__main__":
    main()
