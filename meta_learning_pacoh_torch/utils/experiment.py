"""Experiment bookkeeping: hashed run dirs, result files, launch-command
generation, process-pool fan-out (counterpart of
meta_learning_pacoh_tpu/utils/experiment.py, a copy of it).

Parity with the reference harness (reference: experiments/util.py):
md5(flag-dict) names the run directory (util.py:79-92), `setup_exp_doc`
writes config.json (:23-46), `save_results` writes results.json (:48-61),
`collect_exp_results` globs run dirs back into a DataFrame (:102-125),
`generate_launch_commands` expands flag grids into shell commands (:128-150),
and `AsyncExecutor` is a simple multiprocessing pool (:160-194).
"""

import glob
import hashlib
import itertools
import json
import multiprocessing
import os
import sys
import time

import numpy as np


def hash_dict(d):
    return hashlib.md5(json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()


def _json_safe(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def setup_exp_doc(exp_name, flags_dict, data_dir):
    """Create the run directory `<data_dir>/<exp_name>/<md5(flags)>/` and
    write config.json. Returns the run directory path."""
    run_dir = os.path.join(data_dir, exp_name, hash_dict(flags_dict))
    os.makedirs(run_dir, exist_ok=True)
    config = {k: _json_safe(v) for k, v in flags_dict.items()}
    config["timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S")
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return run_dir


def save_results(results_dict, run_dir, log=True):
    results = {k: _json_safe(v) for k, v in results_dict.items()}
    path = os.path.join(run_dir, "results.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    if log:
        print(f"saved results to {path}")
    return path


def collect_exp_results(exp_name, data_dir, verbose=True):
    """Glob `<data_dir>/<exp_name>/*/{config,results}.json` -> DataFrame."""
    import pandas as pd

    rows = []
    run_dirs = glob.glob(os.path.join(data_dir, exp_name, "*"))
    for run_dir in run_dirs:
        try:
            with open(os.path.join(run_dir, "config.json")) as f:
                row = json.load(f)
            with open(os.path.join(run_dir, "results.json")) as f:
                row.update(json.load(f))
            rows.append(row)
        except FileNotFoundError:
            continue
    if verbose:
        print(f"collected {len(rows)}/{len(run_dirs)} completed runs for {exp_name}")
    return pd.DataFrame(rows)


def generate_launch_commands(module_path, exp_param_dict, check_flags=True):
    """Cartesian product of flag lists -> `python <module> --k v ...` commands."""
    keys = list(exp_param_dict.keys())
    commands = []
    for values in itertools.product(*[exp_param_dict[k] for k in keys]):
        flags = " ".join(f"--{k} {v}" for k, v in zip(keys, values))
        commands.append(f"{sys.executable} {module_path} {flags}")
    return commands


class AsyncExecutor:
    """Fixed-size multiprocessing pool running target(*task) jobs. The
    workers are spawned, not forked: a forked child cannot use CUDA."""

    def __init__(self, n_jobs=1):
        self.num_workers = n_jobs if n_jobs > 0 else multiprocessing.cpu_count()

    def run(self, target, *args_iter, verbose=False):
        tasks = list(zip(*args_iter))
        n_tasks = len(tasks)
        ctx = multiprocessing.get_context("spawn")
        active = []
        done = 0
        while tasks or active:
            active = [p for p in active if p.is_alive()]
            while tasks and len(active) < self.num_workers:
                task = tasks.pop(0)
                p = ctx.Process(target=target, args=task)
                p.start()
                active.append(p)
                done += 1
                if verbose:
                    print(f"task {done} of {n_tasks}")
            time.sleep(0.1)


class LoopExecutor:
    """Sequential fallback with the AsyncExecutor interface."""

    def run(self, target, *args_iter, verbose=False):
        tasks = list(zip(*args_iter))
        for i, task in enumerate(tasks):
            target(*task)
            if verbose:
                print(f"task {i + 1} of {len(tasks)}")
