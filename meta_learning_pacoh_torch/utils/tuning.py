"""Hyperparameter tuning: search spaces, a TPE suggester, and a trial runner
with experiment-state checkpoint/resume (counterpart of
meta_learning_pacoh_tpu/utils/tuning.py, a numpy copy of it: the same seed
gives the same suggestion stream).

Owns the role of the reference's vendored ray-tune (reference: custom_tune/ —
`tune.run` tune.py:59, the TrialRunner event loop with experiment_state-*.json
checkpoints and failure handling trial_runner.py:80-554, and the HyperOptSearch
TPE suggester hyperopt_wrapper.py:32-273) without a Ray cluster: trials are
plain Python calls (optionally subprocess fan-out via AsyncExecutor at the
script layer), the TPE is a compact Parzen-estimator implementation, and the
experiment state is a single JSON file that `resume=True` continues from.
"""

import json
import math
import os
import time

import numpy as np

# --------------------------------------------------------------------------
# search space
# --------------------------------------------------------------------------


class Uniform:
    def __init__(self, low, high):
        self.low, self.high = float(low), float(high)

    def sample(self, rs):
        return float(rs.uniform(self.low, self.high))

    def to_unit(self, v):
        return (v - self.low) / (self.high - self.low)

    def from_unit(self, u):
        return self.low + u * (self.high - self.low)


class LogUniform(Uniform):
    def __init__(self, low, high):
        super().__init__(math.log(low), math.log(high))

    def sample(self, rs):
        return float(math.exp(rs.uniform(self.low, self.high)))

    def to_unit(self, v):
        return (math.log(v) - self.low) / (self.high - self.low)

    def from_unit(self, u):
        return math.exp(self.low + u * (self.high - self.low))


class Choice:
    def __init__(self, options):
        self.options = list(options)

    def sample(self, rs):
        return self.options[rs.randint(len(self.options))]


class Randint:
    def __init__(self, low, high):
        self.low, self.high = int(low), int(high)

    def sample(self, rs):
        return int(rs.randint(self.low, self.high))


def sample_config(space, rs):
    return {k: dist.sample(rs) for k, dist in space.items()}


# --------------------------------------------------------------------------
# TPE suggester (Parzen estimators, hyperopt-style)
# --------------------------------------------------------------------------


class TPESuggest:
    """Tree-structured Parzen Estimator over a flat search space.

    After `n_startup` random trials, splits observations at the `gamma`
    quantile of the metric; per continuous dimension builds Gaussian Parzen
    densities l(x) (good) / g(x) (rest) in unit space, draws candidates from
    l and keeps the candidate maximizing l/g. Categorical dimensions use
    smoothed frequency ratios.
    """

    def __init__(self, space, metric, mode="max", n_startup=20, gamma=0.25,
                 n_candidates=24, seed=0):
        assert mode in ("max", "min")
        self.space, self.metric, self.mode = space, metric, mode
        self.n_startup, self.gamma, self.n_candidates = n_startup, gamma, n_candidates
        self.rs = np.random.RandomState(seed)
        self.observations = []  # (config, value)

    def tell(self, config, value):
        if value is not None and np.isfinite(value):
            self.observations.append((config, float(value)))

    def _split(self):
        vals = np.array([v for _, v in self.observations])
        order = np.argsort(vals)
        if self.mode == "max":
            order = order[::-1]
        n_good = max(1, int(np.ceil(self.gamma * len(vals))))
        good_idx = set(order[:n_good].tolist())
        good = [self.observations[i][0] for i in good_idx]
        rest = [c for i, (c, _) in enumerate(self.observations) if i not in good_idx]
        return good, rest

    @staticmethod
    def _parzen_logpdf(u, centers, bw):
        if len(centers) == 0:
            return 0.0
        z = (u - np.asarray(centers)) / bw
        log_k = -0.5 * z**2 - math.log(bw * math.sqrt(2 * math.pi))
        return float(np.logaddexp.reduce(log_k) - math.log(len(centers)))

    def suggest(self):
        if len(self.observations) < self.n_startup:
            return sample_config(self.space, self.rs)

        good, rest = self._split()
        config = {}
        for name, dist in self.space.items():
            if isinstance(dist, (Choice, Randint)):
                options = dist.options if isinstance(dist, Choice) else \
                    list(range(dist.low, dist.high))
                counts_g = np.array(
                    [sum(1 for c in good if c[name] == o) for o in options], float
                ) + 1.0
                counts_r = np.array(
                    [sum(1 for c in rest if c[name] == o) for o in options], float
                ) + 1.0
                score = counts_g / counts_g.sum() / (counts_r / counts_r.sum())
                probs = score / score.sum()
                config[name] = options[self.rs.choice(len(options), p=probs)]
            else:
                centers_g = [dist.to_unit(c[name]) for c in good]
                centers_r = [dist.to_unit(c[name]) for c in rest]
                bw = max(0.05, 1.0 / max(2, len(centers_g)))
                best_u, best_score = None, -np.inf
                for _ in range(self.n_candidates):
                    if centers_g and self.rs.rand() < 0.8:
                        u = float(np.clip(
                            centers_g[self.rs.randint(len(centers_g))]
                            + bw * self.rs.randn(), 0.0, 1.0,
                        ))
                    else:
                        u = float(self.rs.rand())
                    score = (self._parzen_logpdf(u, centers_g, bw)
                             - self._parzen_logpdf(u, centers_r, bw))
                    if score > best_score:
                        best_u, best_score = u, score
                config[name] = dist.from_unit(best_u)
        return config


class RandomSuggest:
    def __init__(self, space, seed=0, **_):
        self.space = space
        self.rs = np.random.RandomState(seed)

    def tell(self, config, value):
        pass

    def suggest(self):
        return sample_config(self.space, self.rs)


# --------------------------------------------------------------------------
# trial runner
# --------------------------------------------------------------------------


class Analysis:
    """Completed-trial table with dataframe/selection helpers."""

    def __init__(self, trials):
        self.trials = trials

    def dataframe(self):
        import pandas as pd

        rows = []
        for t in self.trials:
            row = {f"config/{k}": v for k, v in t["config"].items()}
            row.update(t.get("last_result") or {})
            row["status"] = t["status"]
            rows.append(row)
        return pd.DataFrame(rows)

    def best_configs(self, metric, mode="max", n=5):
        """Top-n configs by final metric (reference:
        experiments/hyperparam_search/util.py:5-41)."""
        done = [t for t in self.trials
                if t["status"] == "DONE" and t.get("last_result")
                and np.isfinite(t["last_result"].get(metric, np.nan))]
        key = lambda t: t["last_result"][metric]
        done.sort(key=key, reverse=(mode == "max"))
        return [t["config"] for t in done[:n]]


def _newest_experiment_state(local_dir, preferred):
    """Newest experiment_state-*.json in local_dir, preferring `preferred`
    when it exists (reference newest-checkpoint discovery:
    custom_tune/trial_runner.py:40-46)."""
    if os.path.exists(preferred):
        return preferred
    import glob

    cands = glob.glob(os.path.join(local_dir, "experiment_state-*.json"))
    return max(cands, key=os.path.getmtime) if cands else None


def tune_run(trial_fn, space, num_samples=20, metric="test_ll", mode="max",
             search_alg="tpe", seed=0, local_dir="./tune_out", name="tune",
             max_failures=3, resume=False, remote_dir=None, verbose=True,
             batch_size=1, batch_trial_fn=None):
    """Run `num_samples` trials of trial_fn(config) suggested over `space`.

    trial_fn returns a metrics dict, or yields metric dicts for periodic
    reporting (the last yield is the trial's final result). Failures are
    recorded (status ERROR) and retried up to `max_failures` times with a
    fresh suggestion. State is checkpointed to
    `<local_dir>/experiment_state-<name>.json` after every trial.

    batch_size > 1 with batch_trial_fn runs trials in BATCHES: per round,
    `batch_size` suggestions are drawn back-to-back (no intervening tells —
    the batched suggestion stream is exactly the sequential stream with
    tells deferred to batch boundaries), executed together via
    batch_trial_fn(list_of_configs) -> list_of_metric_dicts, and told to
    the suggester in batch order. If batch_trial_fn raises, the whole batch
    falls back to sequential trial_fn calls (per-trial failure accounting
    unchanged). This stands in for the reference's concurrent Ray trials
    (custom_tune/trial_runner.py:80-138): one stacked fit instead of one
    actor per trial (utils/tuning_parallel.py). ``Analysis`` records each
    batched trial's duration as the batch's time over its size.

    resume mirrors the reference's trial_runner modes
    (custom_tune/trial_runner.py:103,288):
      False          — fresh run (default)
      True / "LOCAL" — continue from the newest local experiment-state file
      "REMOTE"       — sync the newest experiment-state file from
                       `remote_dir` (a shared/mounted path — the harness's
                       stand-in for the reference's upload_dir bucket) into
                       local_dir first, then continue from it
      "PROMPT"       — ask interactively iff a local state file exists
    Trials left RUNNING by an interrupted process are marked ERROR
    ("interrupted") on resume, matching the reference's requeue-on-recover
    accounting (trial_runner.py:520-554) without re-running them.
    """
    os.makedirs(local_dir, exist_ok=True)
    state_path = os.path.join(local_dir, f"experiment_state-{name}.json")

    suggester_cls = {"tpe": TPESuggest, "random": RandomSuggest}[search_alg]
    suggester = suggester_cls(space, metric=metric, mode=mode, seed=seed)

    mode_str = resume.upper() if isinstance(resume, str) else None
    if mode_str not in (None, "LOCAL", "REMOTE", "PROMPT"):
        raise ValueError(f"resume must be bool or LOCAL/REMOTE/PROMPT, "
                         f"got {resume!r}")
    if mode_str == "REMOTE":
        if remote_dir is None:
            raise ValueError("resume='REMOTE' requires remote_dir")
        src = _newest_experiment_state(
            remote_dir, os.path.join(remote_dir,
                                     f"experiment_state-{name}.json"))
        if src is None:
            raise FileNotFoundError(
                f"resume='REMOTE': no experiment_state-*.json in {remote_dir}")
        import shutil

        shutil.copy2(src, state_path)
        if verbose:
            print(f"synced remote experiment state {src} -> {state_path}")
    load_path = _newest_experiment_state(local_dir, state_path)
    do_resume = bool(resume) and load_path is not None
    if mode_str == "PROMPT" and do_resume:
        ans = input(f"Resume from {load_path}? [y/N] ")
        do_resume = ans.strip().lower() in ("y", "yes")

    trials = []
    if do_resume:
        with open(load_path) as f:
            trials = json.load(f)["trials"]
        for t in trials:
            if t["status"] == "RUNNING":  # interrupted by a dead process
                t["status"] = "ERROR"
                t["error"] = "interrupted"
            if t["status"] == "DONE" and t.get("last_result"):
                suggester.tell(t["config"], t["last_result"].get(metric))
        if verbose:
            print(f"resumed {len(trials)} trials from {load_path}")

    def checkpoint():
        with open(state_path, "w") as f:
            json.dump({"trials": trials, "timestamp": time.time()}, f, default=str)

    failures = 0

    def run_one(config):
        """One sequential trial; returns True iff it succeeded."""
        nonlocal failures
        trial = {"config": config, "status": "RUNNING", "last_result": None,
                 "history": []}
        trials.append(trial)
        t0 = time.time()
        try:
            result = trial_fn(dict(config))
            if hasattr(result, "__iter__") and not isinstance(result, dict):
                for report in result:
                    trial["history"].append(report)
                    trial["last_result"] = report
            else:
                trial["last_result"] = result
            trial["status"] = "DONE"
            trial["duration"] = time.time() - t0
            suggester.tell(config, (trial["last_result"] or {}).get(metric))
            if verbose:
                n_done = len([t for t in trials if t["status"] == "DONE"])
                print(f"[tune {name}] trial {n_done}/{num_samples} "
                      f"{metric}={ (trial['last_result'] or {}).get(metric) } "
                      f"({trial['duration']:.1f}s)")
            return True
        except Exception as e:  # failure handling (ref trial_runner.py:494)
            trial["status"] = "ERROR"
            trial["error"] = repr(e)
            failures += 1
            if verbose:
                print(f"[tune {name}] trial failed: {e!r} ({failures}/{max_failures})")
            if failures > max_failures:
                checkpoint()
                raise
            return False

    def n_done():
        return len([t for t in trials if t["status"] == "DONE"])

    while n_done() < num_samples:
        if batch_size <= 1 or batch_trial_fn is None:
            run_one(suggester.suggest())
            checkpoint()
            continue
        k = min(batch_size, num_samples - n_done())
        configs = [suggester.suggest() for _ in range(k)]
        t0 = time.time()
        try:
            results = batch_trial_fn([dict(c) for c in configs])
            assert len(results) == k, "batch_trial_fn must return one " \
                                      "result per config"
        except Exception as e:  # whole-batch fallback to sequential trials
            if verbose:
                print(f"[tune {name}] batch of {k} failed ({e!r}); "
                      f"falling back to sequential trials")
            for config in configs:
                run_one(config)
            checkpoint()
            continue
        dur = (time.time() - t0) / k
        for config, result in zip(configs, results):
            trials.append({"config": config, "status": "DONE",
                           "last_result": result, "history": [result],
                           "duration": dur})
            suggester.tell(config, (result or {}).get(metric))
        if verbose:
            print(f"[tune {name}] batch of {k} done "
                  f"({n_done()}/{num_samples}, {dur:.1f}s/trial)")
        checkpoint()

    return Analysis(trials)


def select_best_configs(analysis, metric="test_ll", mode="max", N=5):
    return analysis.best_configs(metric, mode=mode, n=N)
