"""Place the drift of the float32 SVGD general step away from the initial state (ROADMAP C1).

    JAX_PLATFORMS=cpu python tools/c1_drift.py [--out tools/c1_drift.json]

``cauchy_20`` (``provide_data("cauchy_20", seed=28)``: 20 tasks x 20 points,
D=2), ``GPRegressionMetaLearnedSVGD(train, num_particles=10,
random_seed=30)`` with the learner's defaults, as chip_smoke.py's phase 3
builds it. The JAX learner runs its general step on the CPU (Pallas off,
the Stein kernel's median at rank K*K//2 as the TPU kernel and the port take
it) for 1,200 steps in float32, keeping its states at steps 0, 1,000 and
1,200: phase 3's twins start from the state after 1,000 steps and its later
twins 200 steps after that. From each state it runs 20 more steps twice: in
float32 (this process) and in float64 (a child process with
``jax_enable_x64``, the same step function on the state and the data cast to
float64). The port then runs the same 20 steps from the same JAX states on
the CPU: its general step in float32 (``PACOH_TORCH_DISABLE_FUSED=1``) and
its big-N kernel's plain version in float64.

The file keeps, for each state, each float32 run's distance from its
package's float64 run (particles max and mean |diff|, Adam moments max
|diff| over their largest value; the kernel net's output bias left out,
its gradient is exactly zero) and the two float64 runs' distance from each
other. If the JAX float32 step drifts from its float64 run as far as the
port's general step drifts from its own, the drift is float32's, not the
port's.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNER = dict(num_particles=10, random_seed=30)
START, LATER, TWIN = 1000, 200, 20  # phase 3: the twins' state, 200 steps on, 20 twin steps


def jax_learner():
    from meta_learning_pacoh_tpu import GPRegressionMetaLearnedSVGD
    from meta_learning_pacoh_tpu.datasets import provide_data
    from meta_learning_pacoh_tpu.ops import svgd

    def upper_median_gamma(d2):
        import math

        import jax.numpy as jnp

        k = d2.shape[0]
        h = jnp.sort(d2.reshape(-1))[(k * k) // 2] / (2.0 * math.log(k + 1))
        return 1.0 / (1e-8 + 2.0 * h)

    svgd.rbf_median_gamma = upper_median_gamma
    train, _, _ = provide_data("cauchy_20", seed=28)
    model = GPRegressionMetaLearnedSVGD(train, **LEARNER)
    if model._fused_path_ok():
        raise AssertionError("the JAX learner is on a fused path; the general step is wanted")
    return model, train


def flat_state(model):
    s = model.state_dict()
    adam = s["opt_state"][0]
    return {"particles": np.asarray(s["particles"]), "mu": np.asarray(adam.mu),
            "nu": np.asarray(adam.nu), "count": int(adam.count), "step": int(s["step"])}


def jax_twin(model, state, dtype):
    """TWIN steps of the JAX general step from ``state``, in ``dtype``."""
    import jax
    import jax.numpy as jnp

    dt = jnp.dtype(dtype)
    adam = model.opt_state[0]
    opt = (adam._replace(count=jnp.asarray(state["count"], jnp.int32),
                         mu=jnp.asarray(state["mu"], dt), nu=jnp.asarray(state["nu"], dt)),
           ) + tuple(jax.tree.map(jnp.asarray, model.opt_state[1:]))
    p, opt, _ = model._step_fn(jnp.asarray(state["particles"], dt), opt,
                               jnp.asarray(model.X, dt), jnp.asarray(model.Y, dt),
                               jnp.asarray(model.mask, dt), model._train_key, state["step"], TWIN)
    if p.dtype != dt or opt[0].mu.dtype != dt:
        raise AssertionError(f"the {dtype} run came back in {p.dtype}")
    return {"particles": np.asarray(p), "mu": np.asarray(opt[0].mu), "nu": np.asarray(opt[0].nu)}


def child(states_file, out_file):
    """The float64 twins, in a process with jax_enable_x64."""
    import jax

    jax.config.update("jax_enable_x64", True)
    model, _ = jax_learner()
    states = dict(np.load(states_file, allow_pickle=True).item())
    np.save(out_file, {k: jax_twin(model, s, "float64") for k, s in states.items()})


def port_twins(train, states):
    """The port's general step in float32 and its kernel's plain version in
    float64, TWIN steps from each JAX state, on the CPU."""
    import torch

    from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD
    from meta_learning_pacoh_torch.ops import launch_sched
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb

    out = {}
    for key, s in states.items():
        jstate = {"particles": s["particles"],
                  "opt_state": {"mu": s["mu"], "nu": s["nu"], "count": s["count"]},
                  "step": s["step"]}
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
        try:
            gen = GPRegressionMetaLearnedSVGD(train, device="cpu", **LEARNER)
            gen.load_state_dict(jstate)
            if gen._fused_path_ok():
                raise AssertionError("the port's general step is wanted")
            gen.meta_fit(n_iter=TWIN, log_period=TWIN, verbose=False)
        finally:
            os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
        fused = GPRegressionMetaLearnedSVGD(train, device="cpu", **LEARNER)
        if not fused._fused_path_ok():
            raise AssertionError("the port's cauchy_20 learner is off the big-N fused path")
        fused.load_state_dict(jstate)
        fused.meta_fit(n_iter=1, log_period=1, verbose=False)  # builds its trainer
        tr = fused._fused
        dt = torch.float64
        theta, mu, nu = (torch.tensor(s[k], dtype=dt) for k in ("particles", "mu", "nu"))
        data = [t.to(dt) for t in (fused.X, fused.Y, fused.mask)]
        for s0, sub in tr.launches(s["step"], TWIN):
            sb.fused_svgd_bign_train_ref(
                theta, mu, nu, *data, tr.w_t, s0, launch_sched.staircase_lr(tr.lr, tr.lr_decay, s0),
                fused.prior_factor, hidden=tr.hidden, wps=fused._weight_prior_std,
                bps=fused._bias_prior_std, n_steps=sub)
        out[key] = {"general32": {"particles": gen.particles.numpy(), "mu": gen._mu.numpy(),
                                  "nu": gen._nu.numpy()},
                    "plain64": {"particles": theta.numpy(), "mu": mu.numpy(), "nu": nu.numpy()}}
    return out


def gap(a, b, keep):
    d = np.abs(np.asarray(a["particles"], np.float64) - np.asarray(b["particles"], np.float64))
    d = d[:, keep]
    rel = max(float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))[:, keep].max())
              / float(np.abs(np.asarray(b[k], np.float64))[:, keep].max()) for k in ("mu", "nu"))
    return {"max": float(d.max()), "mean": float(d.mean()), "moments_rel": rel}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "tools", "c1_drift.json"))
    parser.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    os.environ["PACOH_TPU_DISABLE_PALLAS"] = "1"
    sys.path.insert(0, ROOT)
    if args.child:
        child(*args.child)
        return

    t0 = time.perf_counter()
    model, train = jax_learner()
    states = {"initial": flat_state(model)}
    model.meta_fit(n_iter=START, log_period=START, verbose=False)
    states["start"] = flat_state(model)
    model.meta_fit(n_iter=LATER, log_period=LATER, verbose=False)
    states["later"] = flat_state(model)
    jax32 = {k: jax_twin(model, s, "float32") for k, s in states.items()}
    with tempfile.TemporaryDirectory() as tmp:
        sf, of = os.path.join(tmp, "states.npy"), os.path.join(tmp, "f64.npy")
        np.save(sf, states)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", sf, of], check=True)
        jax64 = dict(np.load(of, allow_pickle=True).item())
    port = port_twins(train, states)

    from meta_learning_pacoh_torch.models.random_gp import make_hyper_prior, random_gp_config

    cfg = random_gp_config(2, feature_dim=1, mean_nn_layers=(32, 32), kernel_nn_layers=(32, 32))
    hp = make_hyper_prior(cfg)
    keep = np.ones(states["initial"]["particles"].shape[1], bool)
    keep[hp.slice_of(("kernel_nn", "b_out"))] = False
    record = {"config": {"data": "provide_data('cauchy_20', seed=28)",
                         "learner": "GPRegressionMetaLearnedSVGD(num_particles=10, random_seed=30)",
                         "jax_path": "general step on the CPU, median at rank K*K//2",
                         "states": {"initial": 0, "start": START, "later": START + LATER},
                         "twin_steps": TWIN, "excluded_leaf": ["kernel_nn", "b_out"]},
              "gaps": {}}
    for k in states:
        record["gaps"][k] = {
            "jax_f32_vs_jax_f64": gap(jax32[k], jax64[k], keep),
            "port_general_f32_vs_port_plain_f64": gap(port[k]["general32"], port[k]["plain64"], keep),
            "port_plain_f64_vs_jax_f64": gap(port[k]["plain64"], jax64[k], keep),
            "port_general_f32_vs_jax_f32": gap(port[k]["general32"], jax32[k], keep)}
    record["seconds"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record["gaps"], indent=1))


if __name__ == "__main__":
    main()
