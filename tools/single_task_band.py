"""Accuracy bands of the single-task learners from the JAX package, for chip_smoke.py's phase 10.

    JAX_PLATFORMS=cpu python tools/single_task_band.py [--seeds 30-59] [--workers 3]
        [--out tools/single_task_band.json]

For the paths ``gpr_mll_n200`` and ``gpr_pac_n200`` of tools/single_task_ref.py
(GPR-MLL and GPR-PAC with their defaults on the first test task of bench.py's
``map_t5_n200`` environment, 200 context points), fits the JAX learner of
each seed on the CPU (Pallas off) as phase 10 fits the port's: 1,000 steps
in chunks of 250, the task's 200 test points as the validation set (so the
plateau scheduler is stepped after every chunk), then ``eval`` on those test
points. Writes each seed's test LL and RMSE, their mean and std, and the
band phase 10 applies to the mean of seeds 30-32: the mean +- 3 sigma of the
difference of a 3-seed mean and the mean over these seeds, sigma the seeds'
std. The seeds run in ``--workers`` processes.
"""

import argparse
import json
import multiprocessing
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("gpr_mll_n200", "gpr_pac_n200")
N_ITER, LOG_PERIOD = 1000, 250


def fit_seed(path_seed):
    path, seed = path_seed
    os.environ["PACOH_TPU_DISABLE_PALLAS"] = "1"
    sys.path.insert(0, ROOT)
    import meta_learning_pacoh_tpu as jax_pkg
    from tools.single_task_ref import build, path_data

    _, task, _ = path_data()
    model = build(jax_pkg, path, seed=seed)
    model.fit(valid_x=task[2], valid_t=task[3], verbose=False, log_period=LOG_PERIOD,
              n_iter=N_ITER)
    ll, rmse, _ = model.eval(task[2], task[3])
    print(f"{path} seed {seed}: LL {ll:.4f} RMSE {rmse:.4f}", flush=True)
    return path, seed, ll, rmse


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", default="30-59", help="first-last seed")
    parser.add_argument("--workers", type=int, default=3)
    parser.add_argument("--out", default=os.path.join(ROOT, "tools", "single_task_band.json"))
    args = parser.parse_args()
    first, last = (int(v) for v in args.seeds.split("-"))
    seeds = list(range(first, last + 1))
    jobs = [(path, seed) for path in PATHS for seed in seeds]
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        results = pool.map(fit_seed, jobs)
    # 3 sigma of the difference of a 3-seed mean and the mean of these seeds
    margin = 3.0 * np.sqrt(1.0 / 3.0 + 1.0 / len(seeds))
    out = {"how": f"JAX_PLATFORMS=cpu python tools/single_task_band.py --seeds {args.seeds}; "
                  f"the JAX learners on the CPU, Pallas off, {N_ITER} steps in chunks of "
                  f"{LOG_PERIOD} with the test points as the validation set",
           "seeds": seeds}
    for path in PATHS:
        lls = np.array([r[2] for r in results if r[0] == path])
        rmses = np.array([r[3] for r in results if r[0] == path])
        out[path] = {
            "ll": lls.tolist(), "rmse": rmses.tolist(),
            "ll_mean": float(lls.mean()), "ll_std": float(lls.std(ddof=1)),
            "rmse_mean": float(rmses.mean()), "rmse_std": float(rmses.std(ddof=1)),
            "ll_band": [float(lls.mean()), float(margin * lls.std(ddof=1))],
            "rmse_band": [float(rmses.mean()), float(margin * rmses.std(ddof=1))],
        }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({p: {k: out[p][k] for k in ("ll_band", "rmse_band")} for p in PATHS}))


if __name__ == "__main__":
    main()
