"""Record the JAX MAML and NP learners' runs on sin_20: chip_smoke.py phase 11's JAX parity reference.

    JAX_PLATFORMS=cpu python tools/maml_np_ref.py [--out tools/maml_np_ref.json]

The learners (``LEARNERS``) are phase 11's: ``MAMLRegression`` and
``NPRegressionMetaLearned`` with their defaults (MAML 4 x 32 tanh, one inner
step at lr 0.05, Adam at 1e-3, task batch 5; NP r = z = h = 50, AdamW at 1e-3
with weight decay 1e-2, task batch 5) at seed 30 on
``provide_data("sin_20", seed=28)``'s 20 training tasks, as
experiments/baselines/baseline_comparison.py builds them. The JAX learner
runs 200 steps in chunks of 50 on the CPU; the file keeps, for each learner,
its initial and final parameters (the ``ravel_pytree`` order of the
parameter dict, as the base64 of their little-endian bytes), the last loss
of each chunk and the draws of the 200 steps, computed from its train key as
the JAX step draws them: MAML's task indices; the NP's task indices, shuffle
scores and latent noise.

The NP runs in float64 on both sides (``WIDE``; the JAX learner under
``jax.enable_x64`` from its float32 initial parameters, its draws then
float64): on sin_20 the JAX learner's float32 run parts from the float64
arithmetic of the same steps after about 50 steps (3.5e-2 in the
parameters after 200, while the port's float32 run stays within 4e-5 of
its float64 run on the same draws), so a float32 reference would hold the
port to a limit of 0.35. MAML runs in float32 (the port's CPU gap 5.4e-7).

Then the port's learner, started from the same parameters on the CPU and
fed the same draws, runs the same steps in the same precision, and the file
keeps its gap to the JAX run. The tolerance the card's run is held to is
ten times that gap, and at least 1e-5 in the losses (rtol), 1e-4 in the
largest and 1e-5 in the mean parameter difference, as
tools/single_task_ref.py sets its own.
"""

import argparse
import base64
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNERS = ("maml", "np")
WIDE = ("np",)  # the learners whose reference runs in float64
N_STEPS, LOG_EVERY, SEED = 200, 50, 30


def sin20():
    """provide_data("sin_20", seed=28): (20 training tasks, the first 50 test tasks)."""
    from meta_learning_pacoh_torch.datasets import provide_data

    train, _, test = provide_data("sin_20", seed=28)
    return train, test[:50]


def build(pkg, learner, seed=SEED, **kw):
    """The learner ``learner`` of ``pkg`` (the JAX package or the port, which
    export the same names) on sin_20, with its defaults and 10,000 steps."""
    train, _ = sin20()
    cls = pkg.MAMLRegression if learner == "maml" else pkg.NPRegressionMetaLearned
    return cls(train, num_iter_fit=10000, random_seed=seed, **kw)


def run(model, n_steps, every):
    """The last loss of each chunk of ``every`` steps."""
    return [float(model.meta_fit(n_iter=every, log_period=every, verbose=False))
            for _ in range(n_steps // every)]


def pack(a, dtype="<f4"):
    """An array as the base64 of its little-endian bytes."""
    return base64.b64encode(np.ascontiguousarray(a, dtype).tobytes()).decode("ascii")


def unpack(text, shape, dtype="<f4"):
    return np.frombuffer(base64.b64decode(text), dtype).reshape(shape)


def jax_draws(model, learner, n_steps):
    """The JAX learner's draws of steps 0 .. n_steps - 1 (maml.py:177, npr.py:113-122,
    neural_process.py:99-106): {'idx' [S, B]} and, for the NP, 'u' [S, B, N] and
    'eps' [S, B, z_dim]."""
    import jax

    b, t = model.task_batch_size, model.n_tasks
    keys = [jax.random.fold_in(model._train_key, i) for i in range(n_steps)]
    if learner == "maml":
        return {"idx": np.stack([np.asarray(jax.random.randint(k, (b,), 0, t)) for k in keys])}
    n, z_dim = model.X.shape[1], model.params["w_rmu"].shape[1]
    out = {"idx": [], "u": [], "eps": []}
    for key in keys:
        k_task, k_split = jax.random.split(key)
        out["idx"].append(np.asarray(jax.random.randint(k_task, (b,), 0, t)))
        task_keys = jax.random.split(k_split, b)
        out["u"].append(np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in task_keys]))
        out["eps"].append(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, 1),
                                                                 (z_dim,)))
                                    for k in task_keys]))
    return {k: np.stack(v) for k, v in out.items()}


def float_code(record):
    return "<f8" if record["float64"] else "<f4"


def start(port, learner, record, wide=None):
    """Load the JAX learner's initial parameters (fresh moments) into the
    port and give it the recorded JAX draws, in float64 with ``wide`` (by
    default where the record is float64): the port's state and data too."""
    import torch

    from meta_learning_pacoh_torch.models.random_gp import unravel_flat

    wide = record["float64"] if wide is None else wide
    flat = torch.from_numpy(unpack(record["init_params"], (-1,)).copy())
    params = {k: v.numpy() for k, v in unravel_flat(port.layout, flat).items()}
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    port.load_state_dict({"params": params, "step": 0,
                          "opt_state": {"mu": zeros, "nu": dict(zeros), "count": 0}})
    if wide:
        for name in ("params", "_mu", "_nu", "X", "Y", "mask"):
            setattr(port, name, getattr(port, name).double())
    shapes = {k: tuple(v) for k, v in record["draw_shapes"].items()}
    idx = torch.from_numpy(unpack(record["draws"]["idx"], shapes["idx"], "<i4").astype(np.int64))
    if learner == "maml":
        port._task_draw = lambda step: idx[step]
        return
    u, eps = (torch.from_numpy(unpack(record["draws"][k], shapes[k], float_code(record)).copy())
              .to(port.device, port.params.dtype) for k in ("u", "eps"))
    port._step_draws = lambda step: (idx[step], u[step], eps[step])


def gaps(port, record, losses):
    """(max loss rel gap, max param gap, mean param gap) of a port run to the JAX run."""
    final = unpack(record["final_params"], (-1,), float_code(record))
    d = np.abs(port.params.detach().cpu().double().numpy() - final)
    loss_gap = float(np.max(np.abs(np.subtract(losses, record["losses"]))
                            / np.abs(record["losses"])))
    return loss_gap, float(d.max()), float(d.mean())


def jax_run(learner, wide):
    """The JAX learner's initial flat parameters, draws, chunk losses and
    final flat parameters (in float64 if ``wide``, under ``enable_x64``)."""
    import jax
    from jax.flatten_util import ravel_pytree

    import meta_learning_pacoh_tpu as jax_pkg

    jax_model = build(jax_pkg, learner)
    init = np.asarray(ravel_pytree(jax_model.params)[0], np.float32)
    if wide:
        state = jax_model.state_dict()
        cast = lambda tree: {k: np.asarray(v, np.float64) for k, v in tree.items()}  # noqa: E731
        jax_model.params = cast(state["params"])
        jax_model.opt_state = jax_model._opt.init(jax_model.params)
        jax_model.X, jax_model.Y = (np.asarray(a, np.float64) for a in (jax_model.X, jax_model.Y))
        jax_model.mask = np.asarray(jax_model.mask, np.float64)
    draws = jax_draws(jax_model, learner, N_STEPS)
    losses = run(jax_model, N_STEPS, LOG_EVERY)
    return init, draws, losses, np.asarray(ravel_pytree(jax_model.params)[0])


def record(learner):
    import jax

    import meta_learning_pacoh_torch as port_pkg

    t0 = time.perf_counter()
    wide = learner in WIDE
    with jax.enable_x64(wide):
        init, draws, losses, final = jax_run(learner, wide)
    code = "<f8" if wide else "<f4"
    out = {
        "float64": wide,
        "init_params": pack(init),
        "final_params": pack(final, code),
        "losses": losses,
        "draws": {k: pack(v, "<i4" if k == "idx" else code) for k, v in draws.items()},
        "draw_shapes": {k: list(v.shape) for k, v in draws.items()},
        "jax_seconds": time.perf_counter() - t0,
    }
    t0 = time.perf_counter()
    port = build(port_pkg, learner, device="cpu")
    start(port, learner, out)
    if not np.array_equal(port.params.float().numpy(), init):
        raise AssertionError(f"{learner}: the port's flat layout differs from ravel_pytree's")
    port_losses = run(port, N_STEPS, LOG_EVERY)
    loss_gap, gap_max, gap_mean = gaps(port, out, port_losses)
    out["port_cpu"] = {"losses": port_losses, "max_loss_rel_gap": loss_gap,
                       "max_param_gap": gap_max, "mean_param_gap": gap_mean,
                       "seconds": time.perf_counter() - t0}
    out["tolerance"] = {"loss_rtol": max(10 * loss_gap, 1e-5),
                        "param_atol": max(10 * gap_max, 1e-4),
                        "param_mean_atol": max(10 * gap_mean, 1e-5)}
    if wide:
        out["float32"] = float32_gaps(learner)
    return out


def float32_gaps(learner):
    """Why a WIDE learner's reference is float64: the JAX learner's float32
    run against the port's float32 and float64 runs, all on the JAX
    learner's float32 draws, after N_STEPS steps (max, mean parameter gap)."""
    import meta_learning_pacoh_torch as port_pkg

    init, draws, losses, final = jax_run(learner, wide=False)
    rec = {"float64": False, "init_params": pack(init), "final_params": pack(final),
           "losses": losses, "draw_shapes": {k: list(v.shape) for k, v in draws.items()},
           "draws": {k: pack(v, "<i4" if k == "idx" else "<f4") for k, v in draws.items()}}
    runs = {}
    for label, wide in (("port32", False), ("port64", True)):
        port = build(port_pkg, learner, device="cpu")
        start(port, learner, rec, wide)
        run(port, N_STEPS, LOG_EVERY)
        runs[label] = port.params.detach().double().numpy()

    def gap(a, b):
        d = np.abs(a - b)
        return [float(d.max()), float(d.mean())]

    return {"jax32_vs_port32": gap(final, runs["port32"]),
            "jax32_vs_port64": gap(final, runs["port64"]),
            "port32_vs_port64": gap(runs["port32"], runs["port64"])}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "tools", "maml_np_ref.json"))
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    out = {"config": {"learners": list(LEARNERS), "seed": SEED, "steps": N_STEPS,
                      "log_every": LOG_EVERY, "data": 'provide_data("sin_20", seed=28)',
                      "jax_path": "the JAX learners on the CPU"}}
    for learner in LEARNERS:
        out[learner] = record(learner)
        print(learner, json.dumps({k: out[learner].get(k)
                                   for k in ("losses", "port_cpu", "tolerance", "float32")}),
              flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
