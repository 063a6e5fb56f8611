"""Accuracy bands of the MAML and NP learners from the JAX package, for chip_smoke.py's phase 11.

    JAX_PLATFORMS=cpu python tools/maml_np_band.py [--seeds 30-59] [--workers 3]
        [--out tools/maml_np_band.json]

For the learners of tools/maml_np_ref.py (MAMLRegression and
NPRegressionMetaLearned with their defaults on ``provide_data("sin_20",
seed=28)``, as experiments/baselines/baseline_comparison.py runs them), fits
the JAX learner of each seed on the CPU and evaluates ``eval_datasets`` on
the first 50 test tasks after each length of ``LENGTHS`` (one fit, chunked
at those lengths: a chunking leaves the trajectory as it is). MAML's
metric is its RMSE, the NP's its LL and RMSE. For each length, writes each
seed's metrics, their mean and std, and the band phase 11 applies to the
mean of seeds 30-32 fitted as long: the mean +- 3 sigma of the difference
of a 3-seed mean and the mean over these seeds, sigma the seeds' std. The
seeds run in ``--workers`` processes.
"""

import argparse
import json
import multiprocessing
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNERS = ("maml", "np")
LENGTHS = (2000, 10000)  # the band seeds' fit (chip_smoke.MAML_NP_BAND_STEPS), the full fit


def fit_seed(learner_seed):
    learner, seed = learner_seed
    sys.path.insert(0, ROOT)
    import meta_learning_pacoh_tpu as jax_pkg
    from tools.maml_np_ref import build, sin20

    _, test = sin20()
    model = build(jax_pkg, learner, seed=seed)
    out, done = {}, 0
    for length in LENGTHS:
        model.meta_fit(n_iter=length - done, log_period=length - done, verbose=False)
        done = length
        metrics = model.eval_datasets(test)
        out[length] = {"rmse": metrics} if learner == "maml" else dict(
            zip(("ll", "rmse", "calib"), metrics))
    print(f"{learner} seed {seed}: {json.dumps(out)}", flush=True)
    return learner, seed, out


def band(values, n_seeds):
    margin = 3.0 * np.sqrt(1.0 / 3.0 + 1.0 / n_seeds)
    values = np.asarray(values)
    return {"values": values.tolist(), "mean": float(values.mean()),
            "std": float(values.std(ddof=1)),
            "band": [float(values.mean()), float(margin * values.std(ddof=1))]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", default="30-59", help="first-last seed")
    parser.add_argument("--workers", type=int, default=3)
    parser.add_argument("--out", default=os.path.join(ROOT, "tools", "maml_np_band.json"))
    args = parser.parse_args()
    first, last = (int(v) for v in args.seeds.split("-"))
    seeds = list(range(first, last + 1))
    jobs = [(learner, seed) for learner in LEARNERS for seed in seeds]
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        results = pool.map(fit_seed, jobs)
    out = {"how": f"JAX_PLATFORMS=cpu python tools/maml_np_band.py --seeds {args.seeds}; "
                  f"the JAX learners on the CPU with their defaults on sin_20, eval_datasets "
                  f"on the first 50 test tasks after {list(LENGTHS)} steps",
           "seeds": seeds}
    for learner in LEARNERS:
        mine = sorted((r for r in results if r[0] == learner), key=lambda r: r[1])
        out[learner] = {
            str(length): {metric: band([r[2][length][metric] for r in mine], len(seeds))
                          for metric in (("rmse",) if learner == "maml" else ("ll", "rmse"))}
            for length in LENGTHS}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({learner: {length: {m: v["band"] for m, v in rec.items()}
                                for length, rec in out[learner].items()}
                      for learner in LEARNERS}))


if __name__ == "__main__":
    main()
