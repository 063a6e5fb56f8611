"""The ``meta_test`` traffic: meta-test calls in a closed loop, one at a time.

Set-up draws the meta-train tasks from the seed, builds the learner and
fits its prior: step 1 as a launch of its own (the state read after it),
steps 2-3 as one launch (read again), the rest of ``num_iter_fit`` but the
last ``END_STEPS``, then those as one launch, the state read before and
after it. It then makes one call of ``check_steps`` meta-test steps on set 0
(its per-task answers read as the program produces them, before their mean)
and one warm call on set 1. The window calls ``eval_datasets`` on a fresh set
of test tasks (context and test points) each time, from set 2 on, until
``--seconds`` have passed; no set repeats in a run. The sets are drawn after
the meta-train tasks, in order, from the same generator, so set i is the
same whatever the number of sets.

The output check compares with the reference: the fit's first three steps
from the seed; its last ``END_STEPS`` from the program's state before them
(parameters, Adam moments, step count), which the reference follows step by
step; and the check call's per-task answers, from the program's fitted
hyper-posterior and noise, each answer over the tasks whose answer the
reference's own float32 run leaves steady (float32 rounding alone sets the
others'), where at least ``MIN_STEADY`` are. The reference cannot follow the
10,000-step fit: from its own state after three steps no task's answer is
steady (``PERF.md`` §2). The check call runs its ``check_steps`` steps in
launches of ``check_launch`` steps, so that it crosses launch boundaries at
a length at which most tasks' answers are still steady; the window's calls
run the same code in launches of 512. Why the window's 3,000-step answers are not
held to a limit: ``PERF.md`` §2.

Traffic keys: ``env``, ``n_tasks``, ``n_samples`` (the meta-train tasks),
``test_tasks``, ``n_context``, ``n_test`` (a call's set), ``check_steps``,
``check_launch``.
Configuration keys: ``learner``, ``kwargs`` (``num_iter_fit`` the prior
fit's steps), ``n_iter_meta_test``, ``reference`` (``mlap``).
"""

import contextlib
import math
import sys
import time

import numpy as np
import torch

from benchmark import compare, envs
from benchmark.drivers.fit import REFERENCE_STEPS, learner_seed, sync
from benchmark.reference import gp, mlap

CHECK, WARM, FIRST = 0, 1, 2  # the sets (and the calls) of the check, the warm-up, the window
STEADY = 1e-6  # a steady task's answer moves so far in float32 (its gap of ``task_gaps``)
END_STEPS = 3  # the prior fit's last steps, one launch, that the reference follows
SOME = 4  # the planted fault alters every SOME-th task's answer
STATS = (("med", 0.5), ("q90", 0.9), ("max", 1.0))
ANSWERS = ("ll", "rmse", "calib", "mean", "var")
MIN_STEADY = 10  # an answer is compared where at least so many tasks are steady


@contextlib.contextmanager
def launches_of(steps):
    """The program's meta-test cut into launches (and noise blocks) of
    ``steps`` steps while the block runs: the fused mode's launch length and
    the general loop's block length, which the learner draws its noise by."""
    from meta_learning_pacoh_torch.algos import pacoh_mlap
    from meta_learning_pacoh_torch.ops.cuda.fused_mlap_kernel import FusedMLAPMetaTest

    if not hasattr(FusedMLAPMetaTest, "MAX_LAUNCH") or not hasattr(pacoh_mlap,
                                                                    "META_TEST_BLOCK"):
        raise AttributeError("the program's meta-test has no launch length to set")
    old = FusedMLAPMetaTest.MAX_LAUNCH, pacoh_mlap.META_TEST_BLOCK
    FusedMLAPMetaTest.MAX_LAUNCH = pacoh_mlap.META_TEST_BLOCK = int(steps)
    try:
        yield
    finally:
        FusedMLAPMetaTest.MAX_LAUNCH, pacoh_mlap.META_TEST_BLOCK = old


def state_leaves(spec):
    """[(name, key, slice)] of MLAP's state: loc and log_scale by the GP
    parameters' leaves, the noise, the task posteriors."""
    out = []
    for key in ("loc", "log_scale"):
        out += [(f"{key}/{name}", key, sl) for name, sl in gp.leaf_slices(spec.lay)]
    return out + [(k, k, None) for k in ("raw_noise", "q_means", "q_trils")]


def flat_state(tree):
    """A learner's state_dict() leaves as a flat dict of numpy arrays."""
    return {**{k: np.asarray(v) for k, v in tree["hyper_post"].items()},
            **{k: np.asarray(tree[k]) for k in ("raw_noise", "q_means", "q_trils")}}


class Driver:
    def __init__(self, cell, seed, device):
        import meta_learning_pacoh_torch as program

        self.cell, self.seed, self.device = cell, seed, device
        self.kw = dict(cell.config["kwargs"])
        self.n_meta_test = int(cell.config["n_iter_meta_test"])
        self.check_steps = int(cell.traffic["check_steps"])
        self.check_launch = int(cell.traffic["check_launch"])
        self.cls = getattr(program, cell.config["learner"])
        self.records, self.sets = [], []
        self.attempted = self.failed = 0

    # ---------------------------------------------------------------- data
    def _draw_sets(self, n):
        tr = self.cell.traffic
        while len(self.sets) < n:
            self.sets.append(envs.as_float32(self.env.meta_test(
                int(tr["test_tasks"]), int(tr["n_context"]), int(tr["n_test"]))))

    def setup(self, seconds):
        tr = self.cell.traffic
        self.env = envs.environment(tr["env"], self.seed)
        self.train = envs.as_float32(self.env.meta_train(int(tr["n_tasks"]),
                                                          int(tr["n_samples"])))
        learner = self.cls(self.train, random_seed=learner_seed(self.seed, 0),
                           device=self.device, **self.kw)
        got = {"state0": flat_state(learner.state_dict()["params"]), "losses": []}
        for n in (1, REFERENCE_STEPS - 1):  # step 1 alone, then steps 2-3 in one launch
            loss, _ = learner.meta_fit(verbose=False, log_period=n, n_iter=n)
            got["losses"].append(float(loss))
            state = learner.state_dict()
            if n == 1:
                mu = flat_state(state["opt_state"]["mu"])
                got["grad1"] = {k: v / 0.1 for k, v in mu.items()}  # mu_1 = (1 - b1) g_1
        got["state3"] = flat_state(state["params"])
        rest = int(self.kw["num_iter_fit"]) - REFERENCE_STEPS - END_STEPS
        learner.meta_fit(verbose=False, log_period=rest, n_iter=rest)
        before = learner.state_dict()
        loss, _ = learner.meta_fit(verbose=False, log_period=END_STEPS, n_iter=END_STEPS)
        self.fitted = flat_state(learner.state_dict()["params"])
        got["end"] = {"params": flat_state(before["params"]),
                      "mu": flat_state(before["opt_state"]["mu"]),
                      "nu": flat_state(before["opt_state"]["nu"]),
                      "count": int(before["opt_state"]["count"]), "step": int(before["step"]),
                      "after": self.fitted, "loss": float(loss)}
        self.got, self.learner = got, learner
        self._draw_sets(FIRST)
        with launches_of(self.check_launch):
            got["call"] = self.answers_of(learner, self.sets[CHECK], self.check_steps)
        t0 = time.perf_counter()
        learner.eval_datasets(self.sets[WARM], n_iter_meta_test=self.n_meta_test)
        warm = time.perf_counter() - t0
        n, d = self.sets[0][0][0].shape
        self.shape = {"s": int(self.kw.get("svi_batch_size", 5)),
                      "t": int(tr["test_tasks"]), "n": n, "d": d, "n_test": int(tr["n_test"]),
                      "hidden": tuple(self.kw.get("mean_nn_layers", (32, 32))),
                      "p": self.fitted["loc"].shape[0], "steps": self.n_meta_test}
        # the sets of the window: half as many again as the warm call's time fits
        self._draw_sets(FIRST + int(math.ceil(1.5 * seconds / warm)) + 8)

    @staticmethod
    def answers_of(learner, tasks, n_iter):
        """One ``eval_datasets`` call's per-task answers as the program produces
        them, before their mean: {"ll", "rmse", "calib": [T]; "mean", "var":
        [T, Nt] the predictive's moments in normalised units}, numpy arrays
        (None where it made other than one batched evaluation)."""
        seen = {"moments": [], "metrics": []}
        predictive, batch_eval = learner._predictive, learner._run_batch_eval

        def keep(key, fn, pick):
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                seen[key].append(pick(out))
                return out
            return wrapped

        learner._predictive = keep("moments", predictive,
                                   lambda mc: (mc[0], torch.diagonal(mc[1], dim1=-2, dim2=-1)))
        learner._run_batch_eval = keep("metrics", batch_eval, tuple)
        try:
            learner.eval_datasets(tasks, n_iter_meta_test=n_iter)
        finally:
            del learner._predictive, learner._run_batch_eval
        if any(len(v) != 1 for v in seen.values()):
            return None
        parts = (*seen["metrics"][0], *seen["moments"][0])
        return {k: t.detach().cpu().numpy().astype(np.float64) for k, t in zip(ANSWERS, parts)}

    # -------------------------------------------------------------- window
    def window(self, seconds, span):
        t0 = time.perf_counter()
        j = 0
        while j == 0 or time.perf_counter() - t0 < seconds:
            if FIRST + j >= len(self.sets):  # never at the pool's size
                self._draw_sets(FIRST + j + 1)
            tasks = self.sets[FIRST + j]
            answer = None
            with span("bench.call"):
                start = time.perf_counter()
                try:
                    answer = self.learner.eval_datasets(tasks,
                                                        n_iter_meta_test=self.n_meta_test)
                except Exception as err:  # a call that raises counts as failed
                    print(f"call {j} failed: {err!r}", file=sys.stderr)
                end = time.perf_counter()
            if answer is None or not all(math.isfinite(a) for a in answer):
                self.failed += 1
            self.records.append({"start": start, "end": end, "answer": answer,
                                 "ok": answer is not None, "tasks": len(tasks),
                                 "steps": self.n_meta_test})
            j += 1
        self.attempted = len(self.records)
        self.window_s = self.records[-1]["end"] - t0

    def end_to_end(self):
        lat = [1e3 * (r["end"] - r["start"]) for r in self.records]
        tasks = sum(r["tasks"] for r in self.records if r["ok"])
        return {"meta_test_tasks_per_s": tasks / self.window_s,
                "meta_test_p95_ms": float(np.percentile(lat, 95))}

    def release(self):
        self.learner = None
        sync(self.device)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def call_seed(self, call):
        """The learner's seed of its ``call``-th meta-test call (0 the check
        call, 1 the warm call, 2 + j window call j): one draw a call, after
        its initial draws."""
        draws = mlap.LearnerDraws(learner_seed(self.seed, 0), self.fitted["loc"].shape[0])
        for _ in range(call):
            draws.next_seed()
        return draws.next_seed()

    def _spec(self, n_iter=None):
        return mlap.Spec(self.kw, self.shape["d"], self.n_meta_test if n_iter is None else n_iter)

    def _meta_train(self, dtype):
        X, Y = gp.stack_tasks(self.train, gp.normalise(self.train), self.device)
        return X.to(dtype), Y.to(dtype)

    def _keep(self, half, dtype):
        """None, or with ``half`` (a fault) the first half of the meta-train tasks."""
        if not half:
            return None
        keep = torch.zeros(len(self.train), dtype=dtype, device=self.device)
        keep[:len(self.train) // 2] = 1.0
        return keep

    def reference_fit(self, dtype=torch.float64, half=False):
        """The reference's first fit steps as the program's readings; ``half``
        (a fault) leaves out the draws of the later half of the tasks."""
        spec = self._spec()
        X, Y = self._meta_train(dtype)
        state0, grad1, state3, losses = mlap.fit_steps(spec, learner_seed(self.seed, 0), X, Y,
                                                       REFERENCE_STEPS, dtype,
                                                       self._keep(half, dtype))
        host = {k: {n: v.detach().cpu().numpy() for n, v in tree.items()}
                for k, tree in (("state0", state0), ("grad1", grad1), ("state3", state3))}
        return {**host, "losses": [losses[0], losses[-1]], "leaves": state_leaves(spec)}

    def reference_end(self, dtype=torch.float64, half=False):
        """The reference's last ``END_STEPS`` fit steps from the program's state
        before them: {"after": state, "grad": the first one's gradients,
        "loss": the last one's loss}."""
        spec = self._spec()
        end = self.got["end"]
        X, Y = self._meta_train(dtype)

        def dev(a):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        state = {k: dev(end["params"][k]) for k in mlap.STATE}
        mom = {k: (dev(end["mu"][k]), dev(end["nu"][k])) for k in mlap.STATE}
        train_seed = mlap.LearnerDraws(learner_seed(self.seed, 0), spec.p).train_seed
        grad, losses = mlap.follow(spec, train_seed, state, mom, end["step"], end["count"],
                                   END_STEPS, X, Y, self._keep(half, dtype))
        return {"after": {k: v.detach().cpu().numpy() for k, v in state.items()},
                "grad": {k: v.cpu().numpy() for k, v in grad.items()}, "loss": losses[-1]}

    def reference_call(self, call, n_iter, dtype=torch.float64, altered=False):
        """The reference's per-task answers of the learner's ``call``-th
        meta-test call, of ``n_iter`` steps in noise blocks of ``check_launch``
        steps, as ``answers_of`` gives the program's; ``altered`` (a fault) moves every ``SOME``-th task's
        predictive mean by 1e-3."""
        spec = self._spec(n_iter)
        tasks = self.sets[call]
        stats = gp.normalise(self.train)
        Xc, Yc = gp.stack_tasks([t[:2] for t in tasks], stats, self.device)
        TX, _ = gp.stack_tasks([t[2:] for t in tasks], stats, self.device)
        TY = torch.tensor(np.stack([t[3].reshape(-1) for t in tasks]), dtype=dtype,
                          device=self.device)
        q_means, q_trils, theta_agg = mlap.meta_test(spec, self.fitted, self.call_seed(call),
                                                     Xc, Yc, len(self.train), dtype,
                                                     self.check_launch)
        mean, cov = mlap.predictive(spec, q_means, q_trils, theta_agg, Xc.to(dtype),
                                    TX.to(dtype), self.fitted["raw_noise"])
        if altered:
            mean[::SOME] += 1e-3
        out = (*mlap.eval_metrics(mean, cov, TY, stats[2], stats[3]), mean,
               torch.diagonal(cov, dim1=-2, dim2=-1))
        return {k: t.detach().cpu().numpy().astype(np.float64) for k, t in zip(ANSWERS, out)}

    @staticmethod
    def fit_readings(got, ref):
        """The fit's first steps: the loss of step 1 and of step 3 (relative),
        the first gradient's and the three steps' change's worst leaf."""
        leaves = ref["leaves"]
        change = {k: got["state3"][k] - got["state0"][k] for k in got["state0"]}
        ref_change = {k: ref["state3"][k] - ref["state0"][k] for k in ref["state0"]}
        moving = compare.moving(ref["grad1"], leaves)
        return {
            "fit_loss_gap": max(compare.rel_gap(a, b) for a, b in zip(got["losses"],
                                                                       ref["losses"])),
            "fit_grad_gap": compare.worst_leaf_gap(got["grad1"], ref["grad1"], leaves),
            "fit_change_gap": compare.worst_leaf_gap(change, ref_change, leaves, moving),
            "fit_med_grad_gap": compare.median_leaf_gap(got["grad1"], ref["grad1"], leaves),
            "fit_med_change_gap": compare.median_leaf_gap(change, ref_change, leaves, moving),
        }

    @staticmethod
    def end_readings(end, after, loss, ref, leaves):
        """The fit's last steps, the program's state ``after`` them and its last
        ``loss`` against the reference's ``ref`` from the same state ``end``:
        the last loss (relative) and the change's worst leaf."""
        change = {k: after[k] - end["params"][k] for k in end["params"]}
        ref_change = {k: ref["after"][k] - end["params"][k] for k in end["params"]}
        moving = compare.moving(ref["grad"], leaves)
        return {"end_loss_gap": compare.rel_gap(loss, ref["loss"]),
                "end_change_gap": compare.worst_leaf_gap(change, ref_change, leaves, moving),
                "end_med_change_gap": compare.median_leaf_gap(change, ref_change, leaves,
                                                              moving)}

    @staticmethod
    def task_gaps(got, ref):
        """{answer: [T] gap of each task}: RMSE and the predictive variance
        relative (the variance's worst test point), LL in nats a point, the
        predictive mean's worst test point in normalised units."""
        return {"rmse": np.abs(got["rmse"] - ref["rmse"]) / ref["rmse"],
                "ll": np.abs(got["ll"] - ref["ll"]),
                "mean": np.max(np.abs(got["mean"] - ref["mean"]), axis=-1),
                "var": np.max(np.abs(got["var"] - ref["var"]) / ref["var"], axis=-1)}

    @classmethod
    def call_readings(cls, got, ref, steady):
        """A call's per-task answers ``got`` against the reference's ``ref``,
        each answer over its steady tasks (``steady``: {answer: [T] mask}):
        the median, upper quantiles and worst steady task's gap, and the
        count of its steady tasks. An answer with fewer than ``MIN_STEADY``
        steady tasks is not compared (its gaps read 0): float32 rounding sets
        its answers on every task but those few, and on those by chance."""
        out = {f"steady_{key}": int(np.sum(mask)) for key, mask in steady.items()}
        bad = got is None or any(np.shape(got[k]) != np.shape(ref[k]) for k in ref)
        gaps = None if bad else cls.task_gaps(got, ref)
        for key, mask in steady.items():
            for stat, q in STATS:
                out[f"meta_{key}_{stat}_gap"] = (
                    math.inf if bad else 0.0 if mask.sum() < MIN_STEADY
                    else float(np.quantile(gaps[key][mask], q)))
        return out

    def reference_calls(self):
        """The reference's answers of the check call in float64, and for each
        answer compared the mask of the tasks whose gap the reference's own
        float32 run keeps within ``STEADY``: the others' answers are set by
        float32 rounding in any implementation, so the check leaves them out."""
        ref = self.reference_call(CHECK, self.check_steps)
        gaps = self.task_gaps(self.reference_call(CHECK, self.check_steps, torch.float32), ref)
        return ref, {k: g <= STEADY for k, g in gaps.items()}

    def readings(self):
        ref, steady = self.reference_calls()
        end = self.got["end"]
        leaves = state_leaves(self._spec())
        return {**self.fit_readings(self.got, self.reference_fit()),
                **self.end_readings(end, end["after"], end["loss"], self.reference_end(), leaves),
                **self.call_readings(self.got["call"], ref, steady)}

    def checks(self):
        readings = self.readings()
        steady = {k[len("steady_"):]: v for k, v in readings.items() if k.startswith("steady_")}
        print(f"steady tasks of the check call (compared where at least {MIN_STEADY}): "
              f"{steady}", file=sys.stderr)
        return [(name, readings[name], float(self.cell.limits[name]))
                for name in self.cell.limits]

    def calibration(self, controls):
        """{label: readings} after set-up: the program's ("sound") and, with
        ``controls``, the reference computed in TF32 in the program's place
        ("control"), in float32 alone ("float32"), with the later half of the
        meta-train tasks' draws left out ("half_batch", the fit's numbers),
        with the check call's posteriors left at their start ("unchanged") and
        with every ``SOME``-th task's answer altered ("some_altered")."""
        leaves = state_leaves(self._spec())
        end = self.got["end"]
        ref_fit, ref_end = self.reference_fit(), self.reference_end()
        ref_call, steady = self.reference_calls()

        def fit_and_end(fit, last):
            return {**self.fit_readings(fit, ref_fit),
                    **self.end_readings(end, last["after"], last["loss"], ref_end, leaves)}

        out = {"sound": {**fit_and_end(self.got, {"after": end["after"], "loss": end["loss"]}),
                         **self.call_readings(self.got["call"], ref_call, steady)}}
        if controls:
            for label, mode in (("control", compare.tf32), ("float32", contextlib.nullcontext)):
                with mode():
                    fit = self.reference_fit(torch.float32)
                    last = self.reference_end(torch.float32)
                    call = self.reference_call(CHECK, self.check_steps, torch.float32)
                out[label] = {**fit_and_end(fit, last),
                              **self.call_readings(call, ref_call, steady)}
            out["half_batch"] = fit_and_end(self.reference_fit(half=True),
                                            self.reference_end(half=True))
            out["unchanged"] = self.call_readings(self.reference_call(CHECK, 0), ref_call, steady)
            out["some_altered"] = self.call_readings(
                self.reference_call(CHECK, self.check_steps, altered=True), ref_call, steady)
        return out
