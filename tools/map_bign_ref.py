"""Record the JAX learner's ``map_t5_n200`` fit: the reference of chip_smoke.py's phase 7.

    JAX_PLATFORMS=cpu python tools/map_bign_ref.py [--out tools/map_bign_ref.json]

bench.py's ``map_t5_n200`` row: ``SinusoidDataset(RandomState(5))``, 5 tasks
x 200 points, ``GPRegressionMetaLearned(train, num_iter_fit=500,
random_seed=1, task_batch_size=-1)`` with the learner's defaults (NN mean
and NN kernel 32x32, feature_dim 2, AdamW lr 1e-3). The JAX learner runs on
the CPU through its XLA step (Pallas off) for 500 steps in chunks of 50; the
file keeps its initial parameters (the JAX parameter tree, which
``interop.from_jax_map_state`` reads), the loss of the last step of each
chunk, and the final flat parameters.

Then the port's learner, started from the same state on the CPU, runs the
same 500 steps through its fused path (the big-N kernel's plain version),
and the file keeps its gap to the JAX run. The tolerance the card's run is
held to is ten times that gap, and at least 1e-5 in the loss (rtol) and 1e-4
in the parameters (atol): float32 sums in another order drift apart over
500 Adam steps, and the kernel adds its own order. The kernel net's output
bias is left out of parameter gaps: its true gradient is exactly zero, so
both sides random-walk float noise there.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS, LOG_EVERY = 500, 50


def tasks():
    from meta_learning_pacoh_tpu.datasets import SinusoidDataset

    env = SinusoidDataset(random_state=np.random.RandomState(5))
    return env.generate_meta_train_data(n_tasks=5, n_samples=200)


def tree_lists(tree):
    return {k: tree_lists(v) if isinstance(v, dict) else np.asarray(v).tolist()
            for k, v in tree.items()}


def run_jax(train):
    from jax.flatten_util import ravel_pytree

    from meta_learning_pacoh_tpu import GPRegressionMetaLearned

    model = GPRegressionMetaLearned(train, num_iter_fit=N_STEPS, random_seed=1,
                                    task_batch_size=-1)
    state0 = model.state_dict()  # immutable JAX arrays: the state at step 0
    losses = [float(model.meta_fit(n_iter=LOG_EVERY, log_period=LOG_EVERY, verbose=False))
              for _ in range(N_STEPS // LOG_EVERY)]
    return state0, losses, np.asarray(ravel_pytree(model.params)[0], np.float32)


def run_port(train, jax_state):
    from meta_learning_pacoh_torch import GPRegressionMetaLearned

    model = GPRegressionMetaLearned(train, num_iter_fit=N_STEPS, random_seed=1,
                                    task_batch_size=-1, device="cpu")
    model.load_state_dict(jax_state)
    if not model._fused_path_ok():
        raise AssertionError("the port's map_t5_n200 learner is off the fused path")
    losses = [model.meta_fit(n_iter=LOG_EVERY, log_period=LOG_EVERY, verbose=False)
              for _ in range(N_STEPS // LOG_EVERY)]
    return model, losses


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "tools", "map_bign_ref.json"))
    args = parser.parse_args()
    os.environ["PACOH_TPU_DISABLE_PALLAS"] = "1"
    sys.path.insert(0, ROOT)
    from meta_learning_pacoh_torch.models.random_gp import layout_slice

    train = tasks()
    t0 = time.perf_counter()
    state0, jax_losses, jax_final = run_jax(train)
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    port, port_losses = run_port(train, state0)
    port_s = time.perf_counter() - t0

    keep = np.ones(jax_final.size, bool)
    keep[layout_slice(port.layout, ("kernel_nn", "b_out"))] = False
    gap = np.abs(port.params.numpy() - jax_final)[keep]
    loss_gap = float(np.max(np.abs(np.subtract(port_losses, jax_losses)) / np.abs(jax_losses)))
    record = {
        "config": {"data": "SinusoidDataset(RandomState(5)), 5 tasks x 200 points",
                   "learner": "GPRegressionMetaLearned(num_iter_fit=500, random_seed=1, "
                              "task_batch_size=-1), defaults otherwise",
                   "jax_path": "XLA step on the CPU (PACOH_TPU_DISABLE_PALLAS=1)",
                   "steps": N_STEPS, "log_every": LOG_EVERY,
                   "excluded_leaf": ["kernel_nn", "b_out"]},
        "init_params": tree_lists(state0["params"]),
        "losses": jax_losses,
        "final_params": jax_final.tolist(),
        "port_cpu": {"losses": port_losses, "max_loss_rel_gap": loss_gap,
                     "max_param_gap": float(gap.max()), "mean_param_gap": float(gap.mean()),
                     "seconds": port_s},
        "jax_seconds": jax_s,
        "tolerance": {"loss_rtol": max(10 * loss_gap, 1e-5),
                      "param_atol": max(10 * float(gap.max()), 1e-4),
                      "param_mean_atol": max(10 * float(gap.mean()), 1e-5)},
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: record[k] for k in ("losses", "port_cpu", "tolerance")}))


if __name__ == "__main__":
    main()
