"""Accuracy band of bench.py's ``svgd_t5_n200`` and ``vi_t5_n200`` fits from the JAX package, for the port's smoke run.

Fits the JAX ``GPRegressionMetaLearnedSVGD`` (``--learner svgd``: 10
particles, ``prior_factor=0.01``) or ``GPRegressionMetaLearnedVI``
(``--learner vi``: the learner's defaults, svi_batch_size 10, diag,
``prior_factor=0.01``) on bench.py's big-N data
(``SinusoidDataset(RandomState(5))``, 5 tasks of 200 points, full batch,
NN mean and NN kernel 32x32, Adam lr 1e-3, 500 steps) for the given seeds
(default 30-32), and prints each seed's test LL and RMSE on the 20 test
tasks of 200 context and 200 test points drawn after the training tasks
(chip_smoke.py's ``bign_data``), the mean and std of each over the seeds,
and the band chip_smoke.py applies to the mean of seeds 30-32: the mean +- 3
sigma of the difference of a 3-seed mean and the mean over these seeds,
sigma the seeds' std.

    JAX_PLATFORMS=cpu python tools/bign_band.py --learner svgd [--seeds 30-59]
    python tools/bign_band.py --learner vi --port --seeds 30-59   # the port, on the card

The JAX learners run their general step on the CPU (Pallas off; the SVGD
transport's bandwidth takes ``jnp.median``, the mean of the two middles,
where the port's kernels take the upper one: a difference far below the
seeds' spread). ``--port`` fits the port's learner instead (built without a
device, so on the card, through its default path) and imports nothing of
JAX. The outputs for seeds 30-59 are kept in tools/bign_band.json, whose
``svgd.jax`` and ``vi.jax`` bands are those of chip_smoke.py's phase 9.
"""

import argparse
import json
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_ITER = 500  # bench.py's fit


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--learner", choices=("svgd", "vi"), required=True)
    parser.add_argument("--seeds", default="30-32", help="first-last seed")
    parser.add_argument("--port", action="store_true")
    args = parser.parse_args()
    first, last = (int(v) for v in args.seeds.split("-"))
    seeds = range(first, last + 1)

    if args.port:
        import meta_learning_pacoh_torch as package
        from meta_learning_pacoh_torch.datasets import SinusoidDataset
    else:
        import meta_learning_pacoh_tpu as package
        from meta_learning_pacoh_tpu.datasets import SinusoidDataset
    env = SinusoidDataset(random_state=np.random.RandomState(5))
    train = env.generate_meta_train_data(n_tasks=5, n_samples=200)
    test = env.generate_meta_test_data(n_tasks=20, n_samples_context=200, n_samples_test=200)
    if args.learner == "svgd":
        def build(seed):
            return package.GPRegressionMetaLearnedSVGD(
                train, num_iter_fit=N_ITER, num_particles=10, random_seed=seed,
                prior_factor=0.01, task_batch_size=-1)
    else:
        def build(seed):
            return package.GPRegressionMetaLearnedVI(
                train, num_iter_fit=N_ITER, random_seed=seed, task_batch_size=-1)
    lls, rmses = [], []
    for seed in seeds:
        model = build(seed)
        model.meta_fit(verbose=False, log_period=N_ITER)
        ll, rmse, _ = model.eval_datasets(test)
        lls.append(ll)
        rmses.append(rmse)
        print(f"seed {seed}: LL {ll:.4f} RMSE {rmse:.4f}", flush=True)
    lls, rmses = np.array(lls), np.array(rmses)
    # 3 sigma of the difference of a 3-seed mean and the mean of these seeds
    margin = 3.0 * np.sqrt(1.0 / 3.0 + 1.0 / len(seeds))
    std = (lambda a: float(a.std(ddof=1))) if len(seeds) > 1 else (lambda a: float("nan"))
    print(json.dumps({
        "ll": lls.tolist(), "rmse": rmses.tolist(),
        "ll_mean": float(lls.mean()), "ll_std": std(lls),
        "rmse_mean": float(rmses.mean()), "rmse_std": std(rmses),
        "ll_band": [float(lls.mean()), margin * std(lls)],
        "rmse_band": [float(rmses.mean()), margin * std(rmses)],
    }))


if __name__ == "__main__":
    main()
