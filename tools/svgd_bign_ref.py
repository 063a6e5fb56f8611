"""Record the JAX learner's ``svgd_t5_n200`` run: the reference of chip_smoke.py's phase 9.

    JAX_PLATFORMS=cpu python tools/svgd_bign_ref.py [--out tools/svgd_bign_ref.json]

bench.py's ``svgd_t5_n200`` row: ``SinusoidDataset(RandomState(5))``, 5 tasks
x 200 points, ``GPRegressionMetaLearnedSVGD(train, num_iter_fit=500,
num_particles=10, random_seed=1, prior_factor=0.01, task_batch_size=-1)``
with the learner's defaults (NN mean and NN kernel 32x32, feature_dim 1,
Adam lr 1e-3). The JAX learner runs on the CPU through its general step
(Pallas off) for 50 steps; the full batch draws nothing after the
initialisation. Its Stein transport takes the median of the K*K squared
distances at rank K*K//2, the upper middle, as its Stein kernel
(ops/pallas/svgd_kernel.py) does on the TPU and as the port's kernels do:
the Pallas-off path's ``jnp.median`` (the mean of the two middles) is
replaced for this run, in this process only. The file keeps the initial and
final particles [10, 2308] (each float32 in its shortest decimal form).

Then the port's learner, started from the same particles on the CPU, runs
the same 50 steps through its big-N fused path (the kernel's plain
version), and the file keeps its gap to the JAX run. The tolerance the
card's run is held to is ten times that gap, and at least 1e-4 in the
largest and 1e-5 in the mean particle difference: float32 sums in another
order drift apart over Adam steps, and the kernel adds its own order. The
kernel net's output bias is left out of the gaps: its true gradient is
exactly zero, so both sides random-walk float noise there.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 50
LEARNER = dict(num_iter_fit=500, num_particles=10, random_seed=1, prior_factor=0.01,
               task_batch_size=-1)


def tasks():
    from meta_learning_pacoh_tpu.datasets import SinusoidDataset

    env = SinusoidDataset(random_state=np.random.RandomState(5))
    return env.generate_meta_train_data(n_tasks=5, n_samples=200)


def short(a):
    """float32 values as lists of their shortest decimal forms."""
    return [[float(str(v)) for v in row] for row in np.asarray(a, np.float32)]


def upper_median_gamma(d2):
    """``ops/svgd.rbf_median_gamma`` with the median at rank K*K//2."""
    import math

    import jax.numpy as jnp

    k = d2.shape[0]
    h = jnp.sort(d2.reshape(-1))[(k * k) // 2] / (2.0 * math.log(k + 1))
    return 1.0 / (1e-8 + 2.0 * h)


def run_jax(train):
    from meta_learning_pacoh_tpu import GPRegressionMetaLearnedSVGD
    from meta_learning_pacoh_tpu.ops import svgd

    svgd.rbf_median_gamma = upper_median_gamma

    model = GPRegressionMetaLearnedSVGD(train, **LEARNER)
    particles0 = np.asarray(model.particles, np.float32).copy()
    model.meta_fit(n_iter=N_STEPS, log_period=N_STEPS, verbose=False)
    return particles0, np.asarray(model.particles, np.float32)


def run_port(train, particles0):
    from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD

    model = GPRegressionMetaLearnedSVGD(train, device="cpu", **LEARNER)
    zeros = np.zeros_like(particles0)
    model.load_state_dict({"particles": particles0,
                           "opt_state": {"mu": zeros, "nu": zeros, "count": 0}, "step": 0})
    if not model._fused_path_ok():
        raise AssertionError("the port's svgd_t5_n200 learner is off the big-N fused path")
    model.meta_fit(n_iter=N_STEPS, log_period=N_STEPS, verbose=False)
    return model


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "tools", "svgd_bign_ref.json"))
    args = parser.parse_args()
    os.environ["PACOH_TPU_DISABLE_PALLAS"] = "1"
    sys.path.insert(0, ROOT)

    train = tasks()
    t0 = time.perf_counter()
    particles0, jax_final = run_jax(train)
    jax_s = time.perf_counter() - t0
    # the file's rounding is exact in float32: both runs start from what it keeps
    particles0 = np.asarray(short(particles0), np.float32)
    t0 = time.perf_counter()
    port = run_port(train, particles0)
    port_s = time.perf_counter() - t0

    keep = np.ones(jax_final.shape[1], bool)
    keep[port.hyper_prior.slice_of(("kernel_nn", "b_out"))] = False
    gap = np.abs(port.particles.numpy() - jax_final)[:, keep]
    record = {
        "config": {"data": "SinusoidDataset(RandomState(5)), 5 tasks x 200 points",
                   "learner": "GPRegressionMetaLearnedSVGD(num_iter_fit=500, num_particles=10, "
                              "random_seed=1, prior_factor=0.01, task_batch_size=-1), defaults "
                              "otherwise",
                   "jax_path": "general step on the CPU (PACOH_TPU_DISABLE_PALLAS=1), the "
                               "median at rank K*K//2",
                   "steps": N_STEPS, "excluded_leaf": ["kernel_nn", "b_out"]},
        "init_particles": short(particles0),
        "final_particles": short(jax_final),
        "port_cpu": {"max_particle_gap": float(gap.max()), "mean_particle_gap": float(gap.mean()),
                     "seconds": port_s},
        "jax_seconds": jax_s,
        "tolerance": {"particle_atol": max(10 * float(gap.max()), 1e-4),
                      "particle_mean_atol": max(10 * float(gap.mean()), 1e-5)},
    }
    with open(args.out, "w") as f:
        json.dump(record, f)
    print(json.dumps({k: record[k] for k in ("port_cpu", "jax_seconds", "tolerance")}))


if __name__ == "__main__":
    main()
