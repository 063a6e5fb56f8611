"""Accuracy band of bench.py's PACOH-MLAP sin_20 fit from the JAX package, for the port's smoke run.

Fits the JAX ``GPRegressionMetaLearnedPAC`` in bench.py's ``mlap``
configuration (bench.py:147-149), as chip_smoke.py's phase 8 does:
SinusoidDataset(RandomState(26)), 20 tasks of 5 points, NN mean and NN
kernel 32x32, feature_dim 1, svi_batch_size 5, diag hyper-posterior,
meta_kl_weight 1e-3, full task batch (drawn with replacement), Adam lr 1e-3,
2,000 steps. For each of the given seeds (default 30-32) it prints the test
LL, RMSE and calibration error of ``eval_datasets`` on the 20 test tasks
(5 context + 50 test points; a 3,000-step meta-test a call), the mean and
std of each over the seeds, and the band chip_smoke.py applies to the mean
of seeds 30-32: the mean +- 3 sigma of the difference of a 3-seed mean and
the mean over these seeds, sigma the seeds' std.

    JAX_PLATFORMS=cpu python tools/mlap_band.py [--n_iter 2000] [--seeds 30-59]
    python tools/mlap_band.py --port --seeds 30-59   # the port's learner, on the card

``--port`` fits the port's learner instead (built without a device, so on
the card) and imports nothing of JAX. The outputs for seeds 30-59 of the
JAX learner on the CPU are kept under ``jax`` in tools/mlap_band.json, whose
``jax.ll_band`` and ``jax.rmse_band`` are the band of chip_smoke.py's
phase 8.
"""

import argparse
import json
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n_iter", type=int, default=2000)
    parser.add_argument("--seeds", default="30-32", help="first-last seed")
    parser.add_argument("--port", action="store_true")
    args = parser.parse_args()
    first, last = (int(v) for v in args.seeds.split("-"))
    seeds = range(first, last + 1)

    if args.port:
        from meta_learning_pacoh_torch import GPRegressionMetaLearnedPAC
        from meta_learning_pacoh_torch.datasets import SinusoidDataset
    else:
        from meta_learning_pacoh_tpu import GPRegressionMetaLearnedPAC
        from meta_learning_pacoh_tpu.datasets import SinusoidDataset
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=20, n_samples_context=5, n_samples_test=50)
    lls, rmses, calibs = [], [], []
    for seed in seeds:
        model = GPRegressionMetaLearnedPAC(train, num_iter_fit=args.n_iter, random_seed=seed,
                                           covar_module="NN", mean_module="NN",
                                           meta_kl_weight=1e-3)
        model.meta_fit(verbose=False, log_period=args.n_iter)
        ll, rmse, calib = model.eval_datasets(test)
        lls.append(ll)
        rmses.append(rmse)
        calibs.append(calib)
        print(f"seed {seed}: LL {ll:.4f} RMSE {rmse:.4f} calib {calib:.4f}", flush=True)
    lls, rmses, calibs = np.array(lls), np.array(rmses), np.array(calibs)
    # 3 sigma of the difference of a 3-seed mean and the mean of these seeds
    margin = 3.0 * np.sqrt(1.0 / 3.0 + 1.0 / len(seeds))
    std = (lambda a: float(a.std(ddof=1))) if len(seeds) > 1 else (lambda a: float("nan"))
    print(json.dumps({
        "seeds": [first, last],
        "ll": lls.tolist(), "rmse": rmses.tolist(), "calib": calibs.tolist(),
        "ll_mean": float(lls.mean()), "ll_std": std(lls),
        "rmse_mean": float(rmses.mean()), "rmse_std": std(rmses),
        "calib_mean": float(calibs.mean()),
        "ll_band": [float(lls.mean()), margin * std(lls)],
        "rmse_band": [float(rmses.mean()), margin * std(rmses)],
    }))


if __name__ == "__main__":
    main()
