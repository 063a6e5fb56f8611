"""The port's experiment CLIs against the originals: shared helpers, flags,
run directories and imports.

The originals under ``experiments/`` define their flags with absl, whose
registry is global (several define the same names), so every original is
read in a child process (``reference``): its flags' names, defaults and
types from ``FLAGS.flags_by_module_dict()``, the values of a command line,
and its run through ``main`` with stub learners (``STUB``): each learner's
constructor keywords, its ``meta_fit`` and ``eval_datasets`` calls, and the
files it writes, with a counting clock in place of ``time.time`` so that
two runs write the same bytes. The port's CLIs run here with the same stubs
and clock (``port_stubs``). Other test files of the experiments import these
helpers.

Here: ``_cli``'s absl-style booleans, its CSV bytes against
``pandas.to_csv`` and its group statistics against pandas' ``groupby().agg()``
(rows with NaN, ints, strings, numpy float32 and float64); every original's
flags against the port's parser, defaults and one command line that is not
the default (a boolean negation, ``--x=v``, comma lists); the run directory
of each per-algorithm CLI at the defaults and at another command line; and
every module of the port's experiments, the demo and the helpers' modules
imported with ``jax``, ``absl``, ``pandas``, ``matplotlib`` and
``meta_learning_pacoh_tpu`` blocked.
"""

import importlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from meta_learning_pacoh_torch.experiments import _cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "meta_learning_pacoh_torch.experiments."

# (original module, port module) of every CLI with flags
CLIS = {
    "meta_gpr_mll_base_exp": "meta_gpr_mll_base_exp",
    "meta_gpr_svgd_base_exp": "meta_gpr_svgd_base_exp",
    "meta_gpr_vi_base_exp": "meta_gpr_vi_base_exp",
    "meta_mlap_base_exp": "meta_mlap_base_exp",
    "maml_base_exp": "maml_base_exp",
    "npr_base_exp": "npr_base_exp",
    "baselines.baseline_comparison": "baselines.baseline_comparison",
    "baselines.baseline_comparison_n_tasks": "baselines.baseline_comparison_n_tasks",
    "baselines.summarize_baselines": "baselines.summarize_baselines",
    "meta_overfitting.run_overfitting_sweep": "meta_overfitting.run_overfitting_sweep",
    "hyperparam_search.meta_hyperparam_search": "hyperparam_search.meta_hyperparam_search",
    "hyperparam_search.launch_hyperparam_sweeps": "hyperparam_search.launch_hyperparam_sweeps",
}
LEARNERS = ("GPRegressionMetaLearned", "GPRegressionMetaLearnedSVGD",
            "GPRegressionMetaLearnedVI", "GPRegressionMetaLearnedPAC", "MAMLRegression",
            "NPRegressionMetaLearned")

# ------------------------------------------------------------------ the stubs

# Shared by the child (exec'd there) and this process: stub learners that
# record their calls and return metrics derived from what they were given,
# a counting clock, and the patches that put them in place of a package's
# learners, its seed-parallel and hyper-parallel fits.
STUB = r'''
import hashlib, json
import numpy as np

CALLS = []


def plain(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (tuple, list)):
        return [plain(x) for x in v]
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if type(v).__module__.startswith("meta_learning_pacoh"):  # a search-space object
        return {"class": type(v).__name__, **plain(vars(v))}
    return v


def digest(tasks):
    h = hashlib.md5()
    for task in tasks:
        for a in task:
            h.update(np.ascontiguousarray(np.asarray(a, dtype=np.float64)).tobytes())
    return f"{len(tasks)}:{h.hexdigest()[:16]}"


def metrics_of(text):
    h = int(hashlib.md5(text.encode()).hexdigest()[:12], 16)
    return (-1.0 - (h % 997) / 1000.0, 0.5 + ((h >> 12) % 991) / 1000.0,
            ((h >> 24) % 983) / 10000.0)


def make_stub(name):
    class Stub:
        def __init__(self, meta_train_data, **kw):
            kw = {k: plain(v) for k, v in kw.items() if k != "device"}
            self.kw = json.dumps(kw, sort_keys=True)
            self.num_iter_fit = kw.get("num_iter_fit")
            CALLS.append(["init", name, kw, digest(meta_train_data)])

        def meta_fit(self, valid_tuples=None, **kw):
            CALLS.append(["meta_fit", name, None if valid_tuples is None else digest(valid_tuples),
                          plain(kw)])
            if name in FAIL:
                raise RuntimeError("stub failure")

        def eval_datasets(self, test_tuples, **kw):
            d = digest(test_tuples)
            CALLS.append(["eval_datasets", name, d, plain(kw)])
            ll, rmse, calib = metrics_of(self.kw + d)
            return rmse if name == "MAMLRegression" else (ll, rmse, calib)

    Stub.__name__ = name
    return Stub


class Clock:
    """time.time() counting up by 0.25 s a call."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        self.t += 0.25
        return self.t


FAIL = []  # names whose calls raise: a learner class (its meta_fit) or a stacked fit


def fit_models_parallel(models, n_iter=None, **kw):
    CALLS.append(["fit_models_parallel", len(models), n_iter, plain(kw)])
    if "fit_models_parallel" in FAIL:
        raise RuntimeError("stub failure")
    return models


def fit_hyper_parallel(models, n_iter=None, **kw):
    kw.pop("mesh", None)
    CALLS.append(["fit_hyper_parallel", len(models), n_iter, plain(kw)])
    if "fit_hyper_parallel" in FAIL:
        raise RuntimeError("stub failure")
    return models


def patch(package, modules):
    """Stub learners into ``package`` and every module of ``modules`` that
    names them, a clock into each module that has ``time``, and the stacked
    fits into the package's parallel and tuning_parallel modules."""
    import importlib
    stubs = {n: make_stub(n) for n in LEARNERS}
    modules = list(dict.fromkeys(modules))
    pkg = importlib.import_module(package)
    undo = []

    def put(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    for n, s in stubs.items():
        put(pkg, n, s)
        for m in modules:
            if hasattr(m, n):
                put(m, n, s)
    for m in modules:
        if hasattr(m, "time"):
            put(m, "time", Clock())
    put(importlib.import_module(package + ".parallel"), "fit_models_parallel",
        fit_models_parallel)
    put(importlib.import_module(package + ".utils.tuning_parallel"), "fit_hyper_parallel",
        fit_hyper_parallel)
    return undo
'''

# the child: reads jobs (JSON) on stdin, prints one JSON line of results
CHILD = STUB + r'''
import contextlib, importlib, io, os, sys
from absl import flags
FLAGS = flags.FLAGS


def forget():
    names = {f.name for k, fl in FLAGS.flags_by_module_dict().items()
             if k == "experiments" or k.startswith("experiments.") for f in fl}
    for n in names:
        delattr(FLAGS, n)
    for k in list(sys.modules):
        if k == "experiments" or k.startswith("experiments."):
            del sys.modules[k]


def flag_table():
    return {f.name: [f.flag_type(), f.default]
            for k, fl in FLAGS.flags_by_module_dict().items()
            if k == "experiments" or k.startswith("experiments.") for f in fl}


def run(job):
    forget()
    mod = importlib.import_module("experiments." + job["module"])
    out = {"flags": flag_table()}
    argv = job.get("argv")
    if argv is not None:
        FLAGS(["prog"] + argv)
        out["values"] = {name: getattr(FLAGS, name) for name in out["flags"]}
    kind = job["kind"]
    if kind in ("main", "call"):
        CALLS.clear()
        FAIL[:] = job.get("fail", [])
        undo = patch("meta_learning_pacoh_tpu", [mod] + [sys.modules[k] for k in list(sys.modules)
                                                          if k.startswith("experiments.")])
        buf = io.StringIO()
        cwd = os.getcwd()
        os.chdir(job["cwd"])
        try:
            with contextlib.redirect_stdout(buf):
                if kind == "main":
                    mod.main(["prog"])
                else:
                    ret = getattr(mod, job["func"])
                    ret = ret(*job["args"]) if callable(ret) else ret
                    out["return"] = plain(ret) if isinstance(ret, (dict, str)) else None
        finally:
            os.chdir(cwd)
            for obj, attr, value in reversed(undo):
                setattr(obj, attr, value)
        out["calls"] = json.loads(json.dumps(CALLS, default=str))
        out["stdout"] = buf.getvalue()
    FLAGS.unparse_flags()
    return out


results = []
for job in json.loads(sys.stdin.read()):
    results.append(run(job))
print(json.dumps(results, default=lambda v: v.item() if hasattr(v, "item") else str(v)))
'''
STUB = STUB.replace("LEARNERS", repr(LEARNERS))
CHILD = CHILD.replace("LEARNERS", repr(LEARNERS))
_stub = {}
exec(STUB, _stub)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops while an experiments
    file runs (the test workers already share the cores), restored after."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference(jobs):
    """Run ``jobs`` on the originals in one child process: each a dict with
    'module' (under experiments/), 'kind' ('flags', 'main' or 'call'),
    'argv' (a command line, or None), 'cwd' (for 'main' / 'call'), 'func'
    and 'args' (for 'call': a function called, or an attribute read), 'fail' (names whose stubbed calls raise). Returns one dict a job: 'flags' ({name: [type,
    default]}), 'values', 'calls' (the stubs' records), 'stdout', 'return'."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, COLUMNS="250")
    proc = subprocess.run([sys.executable, "-c", CHILD], input=json.dumps(jobs), cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def port_stubs(monkeypatch, *modules, fail=()):
    """The same stubs and clock in the port's package and its CLI modules
    (``fail``: names whose calls raise, as a job's 'fail'); returns the list
    their calls go to."""
    _stub["CALLS"].clear()
    _stub["FAIL"][:] = list(fail)
    mods = list(modules) + [sys.modules[k] for k in list(sys.modules) if k.startswith(PORT)]
    for obj, attr, old in reversed(_stub["patch"]("meta_learning_pacoh_torch", mods)):
        new = getattr(obj, attr)
        setattr(obj, attr, old)
        monkeypatch.setattr(obj, attr, new)  # so that the test's end restores ``old``
    return _stub["CALLS"]


def port_module(name):
    return importlib.import_module(PORT + name)


def port_flags(parser):
    """{name: [absl type, default]} of a port parser."""
    return {name: [kind, parser.get_default(name)] for name, kind in parser.flag_types.items()}


def port_values(parser, argv):
    args = parser.parse(argv)
    return {name: getattr(args, name) for name in parser.flag_types}


def typed(table):
    """{name: (type, repr)} so that 1 and 1.0, or 0 and False, differ."""
    return {k: (type(v).__name__, json.dumps(v)) for k, v in table.items()}


# ------------------------------------------------------------------ _cli


@pytest.mark.parametrize("argv, want", [
    ([], True), (["--normalize_data"], True), (["--nonormalize_data"], False),
    (["--normalize_data=false"], False), (["--normalize_data=False"], False),
    (["--normalize_data=true"], True), (["--normalize_data=0"], False),
    (["--normalize_data=t"], True), (["--nonormalize_data", "--normalize_data"], True),
])
def test_absl_booleans(argv, want):
    """--x, --nox, --x=true/false (and absl's t/f/1/0, in any case), the last one winning."""
    p = port_module("meta_base_exp").base_parser("t")
    assert p.parse(argv).normalize_data is want


def test_absl_types_and_errors():
    """An integer flag gives int (absl's 0x prefix too), a float flag float
    even for '1'; a bad boolean value or an unknown flag is an error."""
    p = port_module("meta_gpr_svgd_base_exp").parser()
    args = p.parse(["--lr", "1", "--seed=0x10", "--bandwidth", "2", "--nn_layers=8,8"])
    assert (type(args.lr), args.lr, type(args.seed), args.seed) == (float, 1.0, int, 16)
    assert (type(args.bandwidth), args.nn_layers) == (float, "8,8")
    for bad in (["--normalize_data=maybe"], ["--no_such_flag", "1"], ["--noseed"]):
        with pytest.raises(SystemExit):
            p.parse(bad)


ROWS = {
    "mixed": [
        {"a": np.float32(0.1), "b": 1, "c": "x", "d": True, "e": np.float64(1e-5), "f": np.nan,
         "g": np.int64(3), "h": 1},
        {"a": np.float32(2.5), "b": np.nan, "c": "y,z", "d": False, "e": 1e16,
         "f": np.float32(0.3), "i": None, "h": 2.5},
        {"a": np.nan, "b": 3, "d": np.nan, "e": 123456789.123, "f": float("inf"),
         "g": np.int32(4), "h": np.float32(1.1)},
    ],
    "float32_kept": [{"a": np.float32(0.1), "b": np.float32(np.nan)},
                     {"a": np.float32(1e-7), "b": np.float32(3e38)}],
    "float32_missing": [{"a": np.float32(0.1)}, {"b": 1}, {"a": None}],
    "ints_and_bools": [{"seed": 22, "ok": True, "n": np.int64(7)},
                       {"seed": 23, "ok": False, "n": np.int32(8)}],
    "int_nan": [{"seed": 22, "x": 1}, {"seed": np.nan, "x": None}],
    "object": [{"a": "x"}, {"a": 1.5}, {"a": np.float32(0.1)}, {"a": 3}, {"a": True}],
    "all_missing": [{"a": None}, {"a": None}],
    "quoting": [{"a": ""}, {"a": 'q"x'}, {"a": "a\nb"}],
    "sweep_row": [{"algo": "pacoh_map", "dataset": "sin", "n_tasks": 4, "weight_decay": 0.1,
                   "seed": 22, "test_rmse_meta_train": 0.1 + 0.2, "test_ll_meta_test": math.nan,
                   "duration": 1.25}],
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_csv_bytes_equal_pandas(tmp_path, case):
    """write_csv's bytes are pd.DataFrame(rows).to_csv(path, index=False)'s."""
    rows = ROWS[case]
    pd.DataFrame(rows).to_csv(tmp_path / "want.csv", index=False)
    _cli.write_csv(rows, tmp_path / "got.csv")
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()


def _stat_rows(seed):
    rs = np.random.RandomState(seed)
    rows = []
    for s in range(60):
        rows.append({"dataset": str(rs.choice(["sin_20", "cauchy_20"])),
                     "algo": str(rs.choice(["maml", "np", "pacoh_map"])), "seed": s,
                     "test_ll": rs.randn() * 10 if rs.rand() > 0.3 else np.nan,
                     "test_rmse": np.float32(rs.rand()), "calib_err": float(rs.rand() / 7)})
    rows.append({"dataset": "solo", "algo": "np", "seed": 1, "test_ll": 1.5, "test_rmse": 0.5,
                 "calib_err": np.nan})
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_group_stats_equal_pandas(tmp_path, seed):
    """group_stats gives pandas' groupby().agg() mean, std (ddof=1) and count,
    NaN skipped, bit for bit; read from the CSV as summarize_baselines reads
    it, against pd.read_csv's frame."""
    from meta_learning_pacoh_torch.experiments.baselines.summarize_baselines import (
        STATS,
        summarize,
    )

    rows = _stat_rows(seed)
    path = tmp_path / "b.csv"
    _cli.write_csv(rows, path)
    want = pd.read_csv(path).groupby(["dataset", "algo"]).agg(**STATS)
    got = summarize(str(path))
    assert [key for key, _ in got] == list(want.index)
    for (key, vals), (_, row) in zip(got, want.iterrows()):
        for name, v in vals.items():
            w = row[name]
            assert (v == w) or (math.isnan(v) and math.isnan(w)), (key, name, v, w)
    direct = pd.DataFrame(rows).groupby("algo")[["test_ll", "test_rmse"]].agg(["mean", "std"])
    got = _cli.group_stats(rows, ["algo"], {(m, f): (m, f) for m in ("test_ll", "test_rmse")
                                            for f in ("mean", "std")})
    for (key, vals), (_, row) in zip(got, direct.iterrows()):
        for name, v in vals.items():
            w = row[name]
            assert (v == w) or (math.isnan(v) and math.isnan(w)), (key, name, v, w)


# ------------------------------------------------------------------ flags

NON_DEFAULT = {
    "meta_gpr_mll_base_exp": ["--dataset", "cauchy_20", "--seed=3", "--lr", "1",
                              "--nonormalize_data", "--nn_layers", "16,8", "--weight_decay=0.5",
                              "--learning_mode", "learn_mean"],
    "meta_gpr_svgd_base_exp": ["--bandwidth", "2", "--normalize_data=false", "--kernel=IMQ",
                               "--num_particles", "4", "--lr_decay", "0.97"],
    "meta_gpr_vi_base_exp": ["--svi_batch_size", "3", "--cov_type=full", "--prior_factor", "1"],
    "meta_mlap_base_exp": ["--n_iter_meta_test", "7", "--meta_kl_weight", "1e-3",
                           "--normalize_data=true", "--task_batch_size", "-1"],
    "maml_base_exp": ["--lr_inner", "1", "--num_inner_steps", "2", "--n_train_tasks", "7"],
    "npr_base_exp": ["--r_dim", "8", "--z_dim=4", "--h_dim", "16", "--weight_decay", "0"],
    "baselines.baseline_comparison": ["--datasets", "sin_20", "--algos=maml,np",
                                      "--seeds", "1,2", "--n_test_tasks", "4"],
    "baselines.baseline_comparison_n_tasks": ["--n_tasks_grid=5,10", "--base_datasets", "sin",
                                              "--output_csv", "x.csv"],
    "baselines.summarize_baselines": ["--csv=other.csv"],
    "meta_overfitting.run_overfitting_sweep": ["--seed_parallel", "--weight_decay_grid",
                                               "0.1,1", "--n_tasks_grid=4,8", "--algo", "np"],
    "hyperparam_search.meta_hyperparam_search": ["--resume=true", "--noseed_parallel",
                                                 "--trial_batch_size", "4", "--algo",
                                                 "pacoh_vi"],
    "hyperparam_search.launch_hyperparam_sweeps": ["--execute=false", "--algos", "pacoh_map"],
}


@pytest.fixture(scope="module")
def originals():
    """{module: the original's flags and the values of its NON_DEFAULT line}."""
    jobs = [{"module": m, "kind": "flags", "argv": NON_DEFAULT[m]} for m in CLIS]
    return dict(zip(CLIS, reference(jobs)))


@pytest.mark.parametrize("module", sorted(CLIS))
def test_flags_match_the_original(originals, module):
    """Each port parser has the original's flags: the same names, absl types
    and defaults (of the same Python types); and one command line that is
    not the default gives the same values of the same types."""
    parser = port_module(CLIS[module]).parser()
    want = originals[module]
    assert typed(port_flags(parser)) == typed(want["flags"])
    got = port_values(parser, NON_DEFAULT[module])
    assert typed(got) == typed(want["values"])
    assert got != {k: v[1] for k, v in want["flags"].items()}


# ------------------------------------------------------------------ run directories

ALGO_CLIS = ("meta_gpr_mll_base_exp", "meta_gpr_svgd_base_exp", "meta_gpr_vi_base_exp",
             "meta_mlap_base_exp", "maml_base_exp", "npr_base_exp")
RUN_LINES = {"default": [], "other": ["--seed", "5", "--lr=1", "--nonormalize_data",
                                      "--nn_layers", "8,4", "--task_batch_size", "3"]}


@pytest.fixture(scope="module")
def original_runs(tmp_path_factory):
    """Each per-algorithm original run through main with the stub learners,
    at the default flags and at RUN_LINES['other'], into its own directory."""
    base = tmp_path_factory.mktemp("orig")
    jobs, keys = [], []
    for m in ALGO_CLIS:
        for line, argv in RUN_LINES.items():
            out = base / m / line
            out.mkdir(parents=True)
            jobs.append({"module": m, "kind": "main", "cwd": str(out),
                         "argv": argv + ["--data_dir", str(out / "exp")]})
            keys.append((m, line))
    return base, dict(zip(keys, reference(jobs)))


def run_tree(root):
    """{relative path: (config without its timestamp | results | bytes)}."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            with open(path, "rb") as fh:
                data = fh.read()
            if f == "config.json":
                config = json.loads(data)
                config.pop("timestamp")
                out[rel] = config
            else:
                out[rel] = data
    return out


@pytest.mark.parametrize("line", sorted(RUN_LINES))
@pytest.mark.parametrize("module", ALGO_CLIS)
def test_run_directory_matches_the_original(original_runs, tmp_path, monkeypatch, module, line):
    """At the default flags and at another command line, the port writes the
    original's run directory (<data_dir>/<exp_name>/<md5 of the flags>),
    the same config.json but its timestamp, and the same results.json bytes
    (stub learners, a counting clock); the learner gets the same keywords,
    meta_fit and eval_datasets the same arguments and data."""
    base, runs = original_runs
    want = runs[(module, line)]
    calls = port_stubs(monkeypatch, port_module(module))
    port_module(module).main(RUN_LINES[line] + ["--data_dir", str(tmp_path / "exp")],
                             device="cpu")
    assert json.loads(json.dumps(calls)) == want["calls"]
    assert run_tree(tmp_path / "exp") == run_tree(base / module / line / "exp")


# ------------------------------------------------------------------ imports

BLOCKER = r'''
import importlib, pkgutil, sys
BLOCKED = ("jax", "absl", "pandas", "matplotlib", "meta_learning_pacoh_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")


sys.meta_path.insert(0, Block())
import meta_learning_pacoh_torch.experiments as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
helpers = ["meta_learning_pacoh_torch." + m for m in (
    "ops.distributions", "ops.kernels", "ops.svgd", "models.random_gp", "algos.base",
    "algos.maml", "algos.pacoh_map", "parallel.seed_parallel")]
for name in names + ["meta_learning_pacoh_torch.demo"] + helpers:
    importlib.import_module(name)
from meta_learning_pacoh_torch import demo
demo.NUM_ITER_FIT, demo.LOG_PERIOD = 3, 3
print(len(names), sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED))
demo.main([], device="cpu")
'''


def test_imports_need_no_jax_absl_pandas_or_matplotlib(tmp_path):
    """Every module of meta_learning_pacoh_torch.experiments (the computational
    comparison and the plot scripts among them), the demo and the modules of
    the JAX package's public helpers import with jax, absl, pandas,
    matplotlib and meta_learning_pacoh_tpu blocked; the demo then runs (3
    steps here) and says it could not plot."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", BLOCKER], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "24 []", lines[0]
    assert "Could not plot results" in proc.stdout and "Test RMSE:" in proc.stdout
    assert not (tmp_path / "demo_prediction.png").exists()


# ------------------------------------------------------------------ wiring helpers
# (used by the other experiments test files)

LAYER_KEYS = ("mean_nn_layers", "kernel_nn_layers", "layer_sizes")
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-6
# The calibration error is a step function of the predictive cdf at the test
# points (ops/metrics.py: frequencies at 20 levels): a point whose cdf lies
# within float32 rounding of a level counts on either side, which moves a
# task's error by up to 1 / (N sqrt(20)), 1.1e-3 at the 200 test points of a
# sin_20 task. So it is held to that, LL and RMSE to EVAL_RTOL.
CALIB_ATOL = 1.2e-3


def init_record(calls, index=0):
    """The ``index``-th learner construction recorded by the stubs:
    (class name, keywords with the layer lists as tuples, data digest)."""
    inits = [c for c in calls if c[0] == "init"]
    _, name, kw, data = inits[index]
    return name, {k: tuple(v) if k in LAYER_KEYS else v for k, v in kw.items()}, data


def jax_twin(name, train, kw):
    """The JAX learner the original built: class ``name`` with keywords ``kw``."""
    import meta_learning_pacoh_tpu

    return getattr(meta_learning_pacoh_tpu, name)(train, **kw)


def kept_hyperparameters(model):
    """The plain settings a learner keeps as attributes (numbers, strings,
    tuples and None), its state and runtime attributes aside."""
    skip = {"fitted", "_step_count"}
    return {k: v for k, v in vars(model).items() if k not in skip
            and isinstance(v, (bool, int, float, str, tuple, type(None)))}


def feed_eval_draws(monkeypatch, jax_model, port, test, n_iter_meta_test):
    """Give the port the JAX learner's draws of its next eval_datasets call
    (VI: posterior samples; NP: latents; MLAP: the aggregation's samples, the
    posteriors' start and the meta-test's noise). MAP, SVGD and MAML draw none."""
    import jax
    import jax.numpy as jnp
    import torch

    name = type(port).__name__
    if name == "GPRegressionMetaLearnedVI":
        key = jax.random.PRNGKey(11)
        eps = np.array(jax.random.normal(key, (100, port.hyper_prior.dim), jnp.float32))
        monkeypatch.setattr(jax_model, "_next_key", lambda: key)
        monkeypatch.setattr(port, "_posterior_eps", lambda n: torch.from_numpy(eps[:n]))
    elif name == "NPRegressionMetaLearned":
        from test_torch_npr import _feed_eval

        _feed_eval(port, jax_model, [len(test)])
    elif name == "GPRegressionMetaLearnedPAC":
        from meta_learning_pacoh_torch.models.random_gp import posterior_rsample

        key = jax.random.PRNGKey(7)
        k_init, k_opt, k_theta = jax.random.split(key, 3)
        k_ith, k_ieps = jax.random.split(k_init)
        p, s = port.hyper_prior.dim, port.svi_batch_size

        def normal(k, shape):
            return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

        agg, init_theta = normal(k_theta, (20, p)), normal(k_ith, (20, p))
        init_eps = normal(k_ieps, (len(test), max(len(t[0]) for t in test)))
        steps = (torch.stack([normal(k, (s, p)) for k in jax.random.split(k_opt, n_iter_meta_test)])
                 if n_iter_meta_test else torch.zeros(0, s, p))
        monkeypatch.setattr(jax_model, "_next_key", lambda: key)
        monkeypatch.setattr(port, "_agg_eps", lambda seed: agg)
        monkeypatch.setattr(port, "_init_task_posteriors", lambda post, X, mask, seed: port._init_q(
            posterior_rsample(post, init_theta), init_eps[:, :X.shape[1]], X, mask))
        monkeypatch.setattr(port, "_meta_test_eps", lambda seed, s0, n: steps[s0:s0 + n])


def assert_wiring(monkeypatch, jax_model, port, test, n_iter_meta_test=0):
    """The port learner keeps the JAX learner's hyperparameters, name by name;
    from the JAX learner's state (``load_state_dict``, through interop) and
    with its draws fed in, eval_datasets on ``test`` agrees: LL and RMSE
    within rtol EVAL_RTOL, atol EVAL_ATOL, the calibration within CALIB_ATOL.
    MLAP evaluates after a meta-test of ``n_iter_meta_test`` steps, 0 by
    default: its inner Gram is singular to float32 on sin_20's data, and
    one meta-test step already parts the two packages by 4e-4 of the LL."""
    assert type(port).__name__ == type(jax_model).__name__
    want, got = kept_hyperparameters(jax_model), kept_hyperparameters(port)
    shared = sorted(set(want) & set(got))
    assert {"num_iter_fit", "task_batch_size", "normalize_data"} <= set(shared), shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    port.load_state_dict(jax_model.state_dict())
    feed_eval_draws(monkeypatch, jax_model, port, test, n_iter_meta_test)
    kw = {"n_iter_meta_test": n_iter_meta_test} if hasattr(port, "_meta_test_eps") else {}
    got = np.atleast_1d(port.eval_datasets(test, **kw))
    want = np.atleast_1d(jax_model.eval_datasets(test, **kw))
    np.testing.assert_allclose(got[:2], want[:2], rtol=EVAL_RTOL, atol=EVAL_ATOL)
    np.testing.assert_allclose(got[2:], want[2:], rtol=0, atol=CALIB_ATOL)
