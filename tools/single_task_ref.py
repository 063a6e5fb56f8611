"""Record the JAX learners' runs on chip_smoke.py's phase-10 paths: its JAX parity reference.

    JAX_PLATFORMS=cpu python tools/single_task_ref.py [--out tools/single_task_ref.json]

The paths (``PATHS``; data from the port's ``datasets``, equal to the JAX
package's to the byte):

- ``gpr_mll_n200``: ``GPRegressionLearned`` on the first test task of
  bench.py's ``map_t5_n200`` environment (``SinusoidDataset(RandomState(5))``
  after its 5 training tasks of 200 points): 200 context points;
- ``gpr_mll_n20``: the same learner on the first ``cauchy_20`` test task
  (``provide_data("cauchy_20", seed=28)``): 20 context points, D=2;
- ``gpr_pac_n200``: ``GPRegressionLearnedPAC`` on the ``gpr_mll_n200`` task;
- ``custom_n200``: ``GPRegressionLearned(covar_module=CosineKernel(),
  mean_module=LinearMean())`` on that task;
- ``custom_map_t5_n200``: ``GPRegressionMetaLearned(covar_module=
  MaternKernel(2.5), mean_module=LinearMean(), task_batch_size=-1)`` on
  ``map_t5_n200``'s 5 tasks.

Each learner has the defaults otherwise (NN nets 32x32, feature_dim 2, lr
1e-3) and seed 30. The JAX learner runs on the CPU (Pallas off) for 200
steps in chunks of 50, no validation set; the file keeps, for each path, its
initial and final flat parameters (``ravel_pytree`` order, as the base64 of
their little-endian float32 bytes; of GPR-PAC's q_chol the lower triangle
only: the upper one starts at 0, takes no gradient and only decays, so it
stays 0) and the last loss of each chunk.

Then the port's learner, started from the same parameters on the CPU, runs
the same steps through its kernels' plain versions, and the file keeps its
gap to the JAX run. The tolerance the card's run is held to is ten times
that gap, and at least 1e-5 in the losses (rtol), 1e-4 in the largest and
1e-5 in the mean parameter difference, as tools/map_bign_ref.py sets its
own. The kernel net's output bias is left out of the gaps: its true
gradient is exactly zero, so both sides random-walk float noise there.
"""

import argparse
import base64
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("gpr_mll_n200", "gpr_mll_n20", "gpr_pac_n200", "custom_n200", "custom_map_t5_n200")
N_STEPS, LOG_EVERY, SEED = 200, 50, 30


def path_data():
    """(map_t5_n200's 5 training tasks, its first test task, cauchy_20's first test task)."""
    from meta_learning_pacoh_torch.datasets import SinusoidDataset, provide_data

    env = SinusoidDataset(random_state=np.random.RandomState(5))
    train = env.generate_meta_train_data(n_tasks=5, n_samples=200)
    test = env.generate_meta_test_data(n_tasks=20, n_samples_context=200, n_samples_test=200)
    _, _, cauchy_test = provide_data("cauchy_20", seed=28)
    return train, test[0], cauchy_test[0]


def build(pkg, path, seed=SEED, **kw):
    """The learner of ``path`` from ``pkg`` (the JAX package or the port,
    which export the same names), on its data."""
    train, task, cauchy_task = path_data()
    if path == "custom_map_t5_n200":
        return pkg.GPRegressionMetaLearned(
            train, covar_module=pkg.MaternKernel(2.5), mean_module=pkg.LinearMean(),
            num_iter_fit=500, task_batch_size=-1, random_seed=seed, **kw)
    x, y = (cauchy_task if path == "gpr_mll_n20" else task)[:2]
    if path == "gpr_pac_n200":
        return pkg.GPRegressionLearnedPAC(x, y, num_iter_fit=1000, random_seed=seed, **kw)
    if path == "custom_n200":
        kw.update(covar_module=pkg.CosineKernel(), mean_module=pkg.LinearMean())
    return pkg.GPRegressionLearned(x, y, num_iter_fit=1000, random_seed=seed, **kw)


def run(model, n_steps, every):
    """The last loss of each chunk of ``every`` steps."""
    fit = getattr(model, "fit", None) or model.meta_fit
    return [float(fit(n_iter=every, log_period=every, verbose=False))
            for _ in range(n_steps // every)]


def stored(layout):
    """Which coordinates of a flat vector the file keeps: all but the upper
    triangle of q_chol."""
    keep = np.ones(layout[-1][2] + layout[-1][3], bool)
    for path, shape, offset, size in layout:
        if path == ("q_chol",):
            keep[offset:offset + size] = np.tril(np.ones(shape, bool)).reshape(-1)
    return keep


def skipped(layout):
    """The kernel net's output bias, left out of the parameter gaps."""
    skip = np.zeros(layout[-1][2] + layout[-1][3], bool)
    for path, _, offset, size in layout:
        if path[-2:] == ("kernel_nn", "b_out"):
            skip[offset:offset + size] = True
    return skip


def pack(a):
    """A float32 vector as the base64 of its little-endian bytes."""
    return base64.b64encode(np.asarray(a, "<f4").tobytes()).decode("ascii")


def record(path):
    from jax.flatten_util import ravel_pytree

    import meta_learning_pacoh_torch as port_pkg
    import meta_learning_pacoh_tpu as jax_pkg

    t0 = time.perf_counter()
    jax_model = build(jax_pkg, path)
    state0 = jax_model.state_dict()  # immutable JAX arrays: the state at step 0
    losses = run(jax_model, N_STEPS, LOG_EVERY)
    jax_s = time.perf_counter() - t0
    jax_init = np.asarray(ravel_pytree(state0["params"])[0], np.float32)
    jax_final = np.asarray(ravel_pytree(jax_model.params)[0], np.float32)

    t0 = time.perf_counter()
    port = build(port_pkg, path, device="cpu")
    port.load_state_dict(state0)
    if not np.array_equal(port.params.numpy(), jax_init):
        raise AssertionError(f"{path}: the port's flat layout differs from ravel_pytree's")
    port_losses = run(port, N_STEPS, LOG_EVERY)
    port_s = time.perf_counter() - t0

    keep = stored(port.layout)
    gap = np.abs(port.params.numpy() - jax_final)[~skipped(port.layout)]
    loss_gap = float(np.max(np.abs(np.subtract(port_losses, losses)) / np.abs(losses)))
    return {
        "init_params": pack(jax_init[keep]), "final_params": pack(jax_final[keep]),
        "losses": losses,
        "port_cpu": {"losses": port_losses, "max_loss_rel_gap": loss_gap,
                     "max_param_gap": float(gap.max()), "mean_param_gap": float(gap.mean()),
                     "seconds": port_s},
        "jax_seconds": jax_s,
        "tolerance": {"loss_rtol": max(10 * loss_gap, 1e-5),
                      "param_atol": max(10 * float(gap.max()), 1e-4),
                      "param_mean_atol": max(10 * float(gap.mean()), 1e-5)},
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "tools", "single_task_ref.json"))
    args = parser.parse_args()
    os.environ["PACOH_TPU_DISABLE_PALLAS"] = "1"
    sys.path.insert(0, ROOT)
    out = {"config": {"paths": list(PATHS), "seed": SEED, "steps": N_STEPS,
                      "log_every": LOG_EVERY, "validation_set": None,
                      "jax_path": "XLA step on the CPU (PACOH_TPU_DISABLE_PALLAS=1)",
                      "stored": "flat parameters less q_chol's upper triangle",
                      "excluded_leaf": ["kernel_nn", "b_out"]}}
    for path in PATHS:
        out[path] = record(path)
        print(path, json.dumps({k: out[path][k] for k in ("losses", "port_cpu", "tolerance")}),
              flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
