"""Timing of the four PACOH variants on sin_20: ms per meta-train iteration
and s per task of meta-test inference, cold and warm (counterpart of
experiments/computational_comparison.py).

    python -m meta_learning_pacoh_torch.experiments.computational_comparison [--flag value ...]

The original's flags, learners, calls and output: each learner is built
with the original's keywords, fitted once cold and ``--n_repeats`` times
warm (each warm fit continues from the state the last one left), then
``eval_datasets`` runs twice on the first ``--n_test_tasks`` test tasks
(PACOH-MLAP with a 1,000-step meta-test). One line a learner, then the
results as JSON, also written to ``--output`` when it is given.

On the card a fit or eval returns before the card has finished its work,
so the clock is read only after ``torch.cuda.synchronize``. "Cold" is the
first call on a fresh learner: its first launches, the pages they read, and
the build of the hand-written kernels if the build directory is empty (in
the JAX package it covered XLA's compile). "Warm" is the steady state.
"""

import json
import time

import numpy as np
import torch

from meta_learning_pacoh_torch import (
    GPRegressionMetaLearned,
    GPRegressionMetaLearnedPAC,
    GPRegressionMetaLearnedSVGD,
    GPRegressionMetaLearnedVI,
)
from meta_learning_pacoh_torch.algos.base import resolve_device
from meta_learning_pacoh_torch.datasets import provide_data
from meta_learning_pacoh_torch.experiments._cli import FlagParser

MLAP_META_TEST_STEPS = 1000


def parser():
    p = FlagParser(__doc__.splitlines()[0])
    p.integer("n_iter", 1000, "meta-train iterations to time")
    p.integer("n_repeats", 5, "timing repetitions")
    p.integer("n_test_tasks", 5, "tasks for meta-test timing")
    p.string("output", "", "optional JSON output path")
    return p


def build_models(meta_train, n_iter, device):
    """{name: a function building the learner}, the original's keywords."""
    return {
        "PACOH-MAP": lambda: GPRegressionMetaLearned(
            meta_train, num_iter_fit=n_iter, random_seed=1, device=device),
        "PACOH-SVGD": lambda: GPRegressionMetaLearnedSVGD(
            meta_train, num_iter_fit=n_iter, random_seed=1, device=device),
        "PACOH-VI": lambda: GPRegressionMetaLearnedVI(
            meta_train, num_iter_fit=n_iter, random_seed=1, device=device),
        "PACOH-MLAP": lambda: GPRegressionMetaLearnedPAC(
            meta_train, num_iter_fit=n_iter, random_seed=1,
            covar_module="NN", mean_module="NN", meta_kl_weight=1e-3, device=device),
    }


def main(argv=None, device=None):
    """Time the command line's runs (``argv`` None: ``sys.argv[1:]``) on
    ``device`` (None: the card); returns the results dict."""
    args = parser().parse(argv)
    dev = resolve_device(device)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    meta_train, _, meta_test = provide_data("sin_20")
    meta_test = meta_test[: args.n_test_tasks]

    results = {}
    for name, build in build_models(meta_train, args.n_iter, dev).items():
        model = build()
        t0 = clock()
        model.meta_fit(verbose=False, log_period=args.n_iter, n_iter=args.n_iter)
        cold = clock() - t0
        warm = []
        for _ in range(args.n_repeats):
            t0 = clock()
            model.meta_fit(verbose=False, log_period=args.n_iter, n_iter=args.n_iter)
            warm.append(clock() - t0)
        per_iter_ms = 1000.0 * np.mean(warm) / args.n_iter

        kwargs = {"n_iter_meta_test": MLAP_META_TEST_STEPS} if name == "PACOH-MLAP" else {}
        t0 = clock()
        model.eval_datasets(meta_test, **kwargs)
        test_cold = clock() - t0
        t0 = clock()
        model.eval_datasets(meta_test, **kwargs)
        test_warm = clock() - t0

        results[name] = {
            "train_iter_ms_warm": per_iter_ms,
            "train_cold_total_s": cold,
            "meta_test_per_task_s_warm": test_warm / len(meta_test),
            "meta_test_cold_total_s": test_cold,
        }
        print(f"{name}: {per_iter_ms:.3f} ms/iter (warm), "
              f"{results[name]['meta_test_per_task_s_warm']:.3f} s/task meta-test")

    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
