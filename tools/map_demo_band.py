"""Accuracy band of the PACOH-MAP demo from the JAX package, for the port's smoke run.

Fits the JAX ``GPRegressionMetaLearned`` in the reference demo's
configuration (demo.py: SinusoidDataset(RandomState(26)), 20 tasks of 5
points, weight_decay 0.2, 12,000 steps, task batch 5) for the given seeds
(default 30-32), in the count-weighted mode (PACOH_TPU_MAP_WEIGHTED=1) and in the gather mode, and
prints each seed's test LL and RMSE on the 20 test tasks, the mean and std
of each over the seeds, and the band chip_smoke.py applies to the mean of
seeds 30-32: the mean +- 3 sigma of the difference of a 3-seed mean and the
mean over these seeds, sigma the seeds' std.

    JAX_PLATFORMS=cpu python tools/map_demo_band.py [--n_iter 12000] [--seeds 30-59]
        [--modes counted,gather]
    python tools/map_demo_band.py --port --seeds 30-59   # the port's learner, on the card

``--port`` fits the port's learner instead (built without a device, so on
the card; count-weighted, its only mode), and imports nothing of JAX.

The outputs of these runs for seeds 30-59 (the JAX learner in both modes on
the CPU, the port's on the card) are kept in tools/map_demo_band.json; the
band of chip_smoke.py's phase 5 is that file's ``jax_counted.ll_band`` and
``jax_counted.rmse_band``.

``--cross SEED`` instead fits the port's learner (on the CPU, through the
fused kernel's plain version) four times at that seed, from the
port's or the JAX learner's initial parameters and with the port's or the
JAX learner's task draws, and prints each one's test LL and RMSE: it tells a
fault of the port from the spread that the seed's own numbers bring.
"""

import argparse
import json
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def jax_draws(model, n_iter):
    """The JAX learner's task indices of steps 0 .. n_iter - 1 [n_iter, batch]."""
    import jax

    keys = jax.vmap(lambda i: jax.random.fold_in(model._train_key, i))(np.arange(n_iter))
    draw = jax.vmap(lambda k: jax.random.randint(k, (model.task_batch_size,), 0, model.n_tasks))
    return np.asarray(draw(keys))


def cross(seed, n_iter, train, test):
    import torch

    from meta_learning_pacoh_torch import GPRegressionMetaLearned as PortMAP
    from meta_learning_pacoh_tpu import GPRegressionMetaLearned

    jax_model = GPRegressionMetaLearned(train, weight_decay=0.2, random_seed=seed)
    idx = torch.from_numpy(jax_draws(jax_model, n_iter).astype(np.int64))
    for init in ("port", "jax"):
        for draws in ("port", "jax"):
            model = PortMAP(train, weight_decay=0.2, random_seed=seed, device="cpu")
            if init == "jax":
                model.load_state_dict(jax_model.state_dict())
            if draws == "jax":
                model._task_draw = lambda step: idx[step]
            model.meta_fit(n_iter=n_iter, log_period=n_iter, verbose=False)
            ll, rmse, _ = model.eval_datasets(test)
            print(f"port seed {seed}, {init} init, {draws} draws: LL {ll:.4f} RMSE {rmse:.4f}",
                  flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n_iter", type=int, default=12000)
    parser.add_argument("--seeds", default="30-32", help="first-last seed")
    parser.add_argument("--port", action="store_true")
    parser.add_argument("--modes", default="counted,gather",
                        help="the JAX package's batch modes to fit, comma-separated")
    parser.add_argument("--cross", type=int, metavar="SEED")
    args = parser.parse_args()
    first, last = (int(v) for v in args.seeds.split("-"))
    seeds = range(first, last + 1)

    if args.port:
        from meta_learning_pacoh_torch import GPRegressionMetaLearned
        from meta_learning_pacoh_torch.datasets import SinusoidDataset

        modes = (("port", None),)
    else:
        from meta_learning_pacoh_tpu import GPRegressionMetaLearned
        from meta_learning_pacoh_tpu.datasets import SinusoidDataset

        flags = {"counted": "1", "gather": "0"}
        modes = tuple((mode, flags[mode]) for mode in args.modes.split(","))
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=20, n_samples_context=5, n_samples_test=50)
    if args.cross is not None:
        cross(args.cross, args.n_iter, train, test)
        return
    results = {}
    for mode, flag in modes:
        if flag is not None:
            os.environ["PACOH_TPU_MAP_WEIGHTED"] = flag
        per_seed = {}
        for seed in seeds:
            model = GPRegressionMetaLearned(train, weight_decay=0.2, num_iter_fit=args.n_iter,
                                            random_seed=seed)
            model.meta_fit(verbose=False, log_period=args.n_iter)
            ll, rmse, _ = model.eval_datasets(test)
            per_seed[seed] = (ll, rmse)
            print(f"{mode} seed {seed}: LL {ll:.4f} RMSE {rmse:.4f}", flush=True)
        lls = np.array([v[0] for v in per_seed.values()])
        rmses = np.array([v[1] for v in per_seed.values()])
        # 3 sigma of the difference of a 3-seed mean and the mean of these seeds
        margin = 3.0 * np.sqrt(1.0 / 3.0 + 1.0 / len(seeds))
        results[mode] = {
            "ll": lls.tolist(), "rmse": rmses.tolist(),
            "ll_mean": float(lls.mean()), "ll_std": float(lls.std(ddof=1)),
            "rmse_mean": float(rmses.mean()), "rmse_std": float(rmses.std(ddof=1)),
            "ll_band": [float(lls.mean()), float(margin * lls.std(ddof=1))],
            "rmse_band": [float(rmses.mean()), float(margin * rmses.std(ddof=1))],
        }
    print(json.dumps(results))


if __name__ == "__main__":
    main()
