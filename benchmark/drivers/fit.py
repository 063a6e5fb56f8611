"""The ``fit`` traffic: meta-training fits back to back in a closed loop.

Set-up draws the meta-train tasks from the seed, builds the first learner,
and drives it through its first three steps: step 1 as a ``meta_fit`` call
of its own, steps 2-3 as one call, which is one launch of the fused kernel,
so that the kernel's step loop carries the particles, the Adam moments and
the step count from one step to the next; it reads the state after each
call (the output check compares them with the reference). The window then runs that learner's fit and, while
``--seconds`` have not passed, a fresh learner's fit with the next learner
seed, each ``meta_fit(verbose=False, log_period=n, n_iter=n)`` and a
synchronize that ends it. No fit starts after ``--seconds``.

Traffic keys: ``env`` (``benchmark/envs.py``), ``n_tasks``, ``n_samples``.
Configuration keys: ``learner`` (a class of ``meta_learning_pacoh_torch``),
``kwargs`` (its keywords; ``num_iter_fit`` the steps of a fit),
``reference`` (``svgd``).
"""

import sys
import time

import numpy as np
import torch

from benchmark import compare, envs
from benchmark.reference import gp, svgd

REFERENCE_STEPS = 3


def learner_seed(seed, i):
    """The seed of the run's i-th learner."""
    return int(np.random.SeedSequence([int(seed), int(i)]).generate_state(1)[0])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Driver:
    def __init__(self, cell, seed, device):
        import meta_learning_pacoh_torch as program

        self.cell, self.seed, self.device = cell, seed, device
        self.kw = dict(cell.config["kwargs"])
        self.n_iter = int(self.kw["num_iter_fit"])
        self.cls = getattr(program, cell.config["learner"])
        self.records, self.finals = [], []
        self.attempted = self.failed = 0

    def make(self, i):
        return self.cls(self.train, random_seed=learner_seed(self.seed, i), device=self.device,
                        **self.kw)

    def setup(self, seconds):
        tr = self.cell.traffic
        env = envs.environment(tr["env"], self.seed)
        self.train = envs.as_float32(env.meta_train(int(tr["n_tasks"]), int(tr["n_samples"])))
        first = self.make(0)
        got = {"theta0": first.state_dict()["particles"]}
        first.meta_fit(verbose=False, log_period=1, n_iter=1)
        got["grad1"] = first.state_dict()["opt_state"]["mu"] / 0.1  # mu_1 = (1 - b1) g_1
        rest = REFERENCE_STEPS - 1
        first.meta_fit(verbose=False, log_period=rest, n_iter=rest)
        got["theta3"] = first.state_dict()["particles"]
        self.got, self.first = got, first
        k, p = got["theta0"].shape
        self.shape = {"k": k, "t": len(self.train), "n": self.train[0][0].shape[0],
                      "d": self.train[0][0].shape[1],
                      "hidden": tuple(self.kw.get("mean_nn_layers", (32, 32))), "p": p}

    def window(self, seconds, span):
        n = self.n_iter
        t0 = time.perf_counter()
        i = 0
        while i == 0 or time.perf_counter() - t0 < seconds:
            with span("bench.fit"):
                start = time.perf_counter()
                ret = None
                try:
                    learner = self.first if i == 0 else self.make(i)
                    learner.meta_fit(verbose=False, log_period=n, n_iter=n)
                    ret = time.perf_counter()
                    sync(self.device)
                    self.finals.append(learner.particles)
                except Exception as err:  # a fit that raises counts as failed
                    print(f"fit {i} failed: {err!r}", file=sys.stderr)
                    self.failed += 1
            end = time.perf_counter()
            self.records.append({"start": start, "ret": ret, "end": end, "steps": n,
                                 "ok": ret is not None, "constructed": i > 0})
            i += 1
        self.first = None
        self.attempted = len(self.records)
        self.window_s = self.records[-1]["end"] - t0

    def end_to_end(self):
        steps = sum(r["steps"] for r in self.records if r["ok"])
        return {"fit_steps_per_s": steps / self.window_s}

    def release(self):
        """Counts the fits whose particles are not finite, then frees them."""
        self.failed += sum(not bool(torch.isfinite(f).all()) for f in self.finals)
        self.finals = []
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64, half=False):
        """The reference's first steps from the first learner's seed, as the
        program's readings: theta0, grad1, theta3 [K, P]; ``half`` leaves
        out the later half of the tasks (a fault), ``dtype`` its type."""
        spec = svgd.Spec(self.kw, self.shape["d"])
        tasks = self.train[:len(self.train) // 2] if half else self.train
        X, Y = gp.stack_tasks(tasks, gp.normalise(self.train), self.device)
        theta0, grad1, theta3 = svgd.first_steps(spec, learner_seed(self.seed, 0), X, Y,
                                                 REFERENCE_STEPS, dtype)
        return {"theta0": theta0.detach().cpu().numpy(), "grad1": grad1.cpu().numpy(),
                "theta3": theta3.detach().cpu().numpy(), "leaves": gp.leaf_slices(spec.lay)}

    @staticmethod
    def readings(got, ref):
        """{name: reading} of ``got`` against the reference's ``ref``: the
        first gradient's worst leaf and the three steps' change's worst leaf
        (of the leaves the reference's gradient moves)."""
        leaves = [(name, None, sl) for name, sl in ref["leaves"]]
        return {
            "grad_gap": compare.worst_leaf_gap(got["grad1"], ref["grad1"], leaves),
            "change_gap": compare.worst_leaf_gap(
                got["theta3"] - got["theta0"], ref["theta3"] - ref["theta0"], leaves,
                compare.moving(ref["grad1"], leaves)),
        }

    def checks(self):
        """(name, reading, limit) of the program's first steps."""
        readings = self.readings(self.got, self.reference())
        return [(name, readings[name], float(self.cell.limits[name])) for name in readings]

    def calibration(self, controls):
        """{label: readings} after set-up: the program's ("sound"); with
        ``controls`` also the reference in TF32 in the program's place
        ("control") and the reference on half of the tasks ("half_batch")."""
        ref = self.reference()
        out = {"sound": self.readings(self.got, ref)}
        if controls:
            with compare.tf32():
                out["control"] = self.readings(self.reference(torch.float32), ref)
            out["half_batch"] = self.readings(self.reference(half=True), ref)
        return out
