"""The port's plot and task-view scripts against the originals
(experiments/meta_overfitting/plot_meta_overfitting.py,
experiments/comparison_n_tasks/plot_comparison_n_tasks.py,
experiments/visualization_tasks/visualize_sim_tasks.py), on the CPU.

CSVs in the columns run_overfitting_sweep and the baseline comparisons
write are made from a numpy seed, with NaN metrics, a group whose metric is
NaN throughout, rows below the task filter and a weight-decay tie. Each
original runs in a child process (absl's flags are global) with pandas and
matplotlib (Agg); the port runs here. Held: the flags (names, defaults,
types), the aggregates, and each panel's title, axis scale, labels and
legend, its plotted lines and bands within 1e-12, and the task view's
lines, points and colours exactly. Without matplotlib each port script
fails on its import and writes nothing.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from meta_learning_pacoh_torch.experiments._cli import write_csv
from test_torch_experiments_cli import ROOT, port_flags, port_module, typed

OVERFIT = "meta_overfitting.plot_meta_overfitting"
N_TASKS = "comparison_n_tasks.plot_comparison_n_tasks"
TASKS = "visualization_tasks.visualize_sim_tasks"
TOL = 1e-12

CHILD = r'''
import contextlib, importlib, io, json, sys
import matplotlib
matplotlib.use("Agg")
import numpy as np
import pandas as pd
from absl import flags
from matplotlib import pyplot as plt

FLAGS = flags.FLAGS


def forget():
    names = {f.name for k, fl in FLAGS.flags_by_module_dict().items()
             if k.startswith("experiments.") for f in fl}
    for n in names:
        delattr(FLAGS, n)
    for k in list(sys.modules):
        if k == "experiments" or k.startswith("experiments."):
            del sys.modules[k]


def nan_list(a):
    return [None if v != v else v for v in np.asarray(a, dtype=float).ravel().tolist()]


def figure():
    fig = plt.figure(plt.get_fignums()[-1])
    return [AXIS(ax) for ax in fig.axes]


def frame(df):
    return [[float(i), {f"{m}|{s}": (None if v != v else float(v)) for (m, s), v in row.items()}]
            for i, row in df.iterrows()]


results = []
for job in json.loads(sys.stdin.read()):
    forget()
    mod = importlib.import_module("experiments." + job["module"])
    out = {"flags": {f.name: [f.flag_type(), f.default]
                     for k, fl in FLAGS.flags_by_module_dict().items()
                     if k.startswith("experiments.") for f in fl}}
    if job["argv"] is not None:
        FLAGS(["prog"] + job["argv"])
        plt.close("all")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["prog"])
        out["stdout"] = buf.getvalue()
        out["figure"] = figure() if plt.get_fignums() else None
        if job["module"].endswith("plot_meta_overfitting"):
            out["aggregate"] = [frame(mod.aggregate(pd.read_csv(p), FLAGS.select_best_wd))
                                for p in FLAGS.csvs.split(",")]
        elif job["module"].endswith("plot_comparison_n_tasks"):
            frames = [pd.read_csv(p) for p in FLAGS.csv.split(",")]
            out["aggregate"] = mod.aggregate(pd.concat(frames, ignore_index=True), FLAGS.metric)
        FLAGS.unparse_flags()
    results.append(out)
print(json.dumps(results))
'''

# one panel's data, as the child and this process read it
AXIS = r'''
def AXIS(ax):
    import numpy as np
    from matplotlib.collections import PathCollection, PolyCollection

    def nan_list(a):
        return [None if v != v else v for v in np.asarray(a, dtype=float).ravel().tolist()]

    legend = ax.get_legend()
    return {
        "title": ax.get_title(), "xscale": ax.get_xscale(), "xlabel": ax.get_xlabel(),
        "ylabel": ax.get_ylabel(), "xticks": nan_list(ax.get_xticks()),
        "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        "lines": [{"label": ln.get_label(), "xy": nan_list(ln.get_xydata()),
                   "color": list(matplotlib.colors.to_rgba(ln.get_color())),
                   "alpha": ln.get_alpha(), "lw": ln.get_linewidth()} for ln in ax.get_lines()],
        "bands": [[nan_list(p.vertices) for p in c.get_paths()] for c in ax.collections
                  if isinstance(c, PolyCollection)],
        "points": [{"xy": nan_list(c.get_offsets()), "color": nan_list(c.get_facecolor())}
                   for c in ax.collections if isinstance(c, PathCollection)],
    }
'''
CHILD = CHILD.replace("\n\nresults = []", "\n\n" + AXIS + "\n\nresults = []")
_axis = {}
exec("import matplotlib\n" + AXIS, _axis)


def originals_of(jobs):
    env = dict(os.environ, PYTHONPATH=ROOT, MPLBACKEND="Agg")
    proc = subprocess.run([sys.executable, "-c", CHILD], input=json.dumps(jobs), cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------------ the CSVs


def sweep_rows(seed, dataset, weight_decays):
    """run_overfitting_sweep's columns: NaN metrics, a (8, 0.5) group NaN
    throughout in the meta-test RMSE, n_tasks 2 below the default filter,
    and at n_tasks 16 a tie of the least meta-test RMSE between weight
    decays 0.1 and 0.5 whose meta-train RMSEs differ."""
    rs = np.random.RandomState(seed)
    rows = []
    for n in (2, 4, 8, 16):
        for wd in weight_decays:
            for s in (22, 23, 24):
                train, test = float(rs.rand()), float(rs.rand() + 0.2 * (wd == 0.0))
                tie = n == 16 and wd in (0.1, 0.5)
                if tie:
                    test = 0.05 * (s - 21)  # the same values, in the same order
                if (n == 8 and wd == 0.5) or (rs.rand() < 0.1 and not tie):
                    test = math.nan
                if rs.rand() < 0.1:
                    train = math.nan
                rows.append({"algo": "pacoh_map", "dataset": dataset, "n_tasks": n,
                             "weight_decay": wd, "seed": s, "test_rmse_meta_train": train,
                             "test_rmse_meta_test": test, "test_ll_meta_train": -rs.rand(),
                             "test_ll_meta_test": -rs.rand(), "calib_err": rs.rand() / 5,
                             "duration": rs.rand()})
    return rows


def n_tasks_rows(seed, with_column):
    """baseline_comparison_n_tasks's columns (with_column) or
    baseline_comparison's (no n_train_tasks: taken from the dataset's name)."""
    rs = np.random.RandomState(seed)
    rows = []
    for family in ("sin", "cauchy"):
        for n in (5, 10, 20):
            for algo in ("pacoh_map", "maml", "gpr_meta_mll", "custom_algo"):
                for s in (22, 23, 24)[:1 + (n != 20) * 2]:
                    row = {"algo": algo, "dataset": f"{family}_{n}"}
                    if with_column:
                        row["n_train_tasks"] = n
                    row.update({"seed": s, "test_ll": -rs.rand() * 3 if rs.rand() > 0.15
                                else math.nan, "test_rmse": rs.rand() if rs.rand() > 0.15
                                else math.nan, "calib_err": rs.rand() / 5})
                    rows.append(row)
    return rows


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    base = tmp_path_factory.mktemp("csvs")
    files = {"sweep_sin": sweep_rows(0, "sin", (0.0, 0.1, 0.5)),
             "sweep_cauchy": sweep_rows(1, "cauchy", (0.2,)),
             "n_tasks": n_tasks_rows(2, True), "baselines": n_tasks_rows(3, False)}
    for name, rows in files.items():
        write_csv(rows, base / f"{name}.csv")
    return base


def runs(base):
    """{name: (module, argv)}; each run writes out_<name>.png in ``base``."""
    sweep, cauchy = str(base / "sweep_sin.csv"), str(base / "sweep_cauchy.csv")
    lines = {
        "overfit": (OVERFIT, ["--csvs", f"{sweep},{cauchy}"]),
        "overfit_all_wd": (OVERFIT, ["--csvs", sweep, "--noselect_best_wd", "--min_n_tasks=2"]),
        "n_tasks": (N_TASKS, ["--csv", f"{base / 'n_tasks.csv'},{base / 'baselines.csv'}"]),
        "n_tasks_ll": (N_TASKS, ["--csv", str(base / "baselines.csv"), "--metric", "test_ll"]),
        "tasks": (TASKS, []),
        "tasks_all": (TASKS, ["--envs", "sin,cauchy,mixture,gp_funcs", "--n_tasks", "3",
                              "--n_samples", "12", "--seed=7"]),
    }
    return {k: (m, argv + ["--output", str(base / f"out_{k}.png")]) for k, (m, argv) in
            lines.items()}


@pytest.fixture(scope="module")
def originals(csvs):
    lines = runs(csvs)
    jobs = [{"module": m, "argv": argv} for m, argv in lines.values()]
    return dict(zip(lines, originals_of(jobs)))


@pytest.fixture()
def port_run(csvs):
    """Run a port script's main here (Agg); returns (its result, its figure's
    panels, its stdout)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    def run(name, capsys):
        module, argv = runs(csvs)[name]
        plt.close("all")
        result = port_module(module).main(argv)
        fig = plt.figure(plt.get_fignums()[-1])
        panels = json.loads(json.dumps([_axis["AXIS"](ax) for ax in fig.axes]))
        plt.close("all")
        return result, panels, capsys.readouterr().out

    return run


def assert_close(got, want, path="."):
    """Nested lists / dicts equal, floats within TOL (None for NaN on both sides)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and isinstance(got, (int, float)):
        assert abs(got - want) <= TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("module, name", [(OVERFIT, "overfit"), (N_TASKS, "n_tasks"),
                                          (TASKS, "tasks")])
def test_flags_match_the_original(originals, module, name):
    """Each script's flags: names, absl types and defaults of the same types."""
    assert typed(port_flags(port_module(module).parser())) == typed(originals[name]["flags"])


@pytest.mark.parametrize("name", ["overfit", "overfit_all_wd"])
def test_meta_overfitting_matches_the_original(originals, port_run, capsys, name):
    """The aggregate of each CSV (the best weight decay a task count, ties to
    the first; the population std; NaN skipped, a group NaN throughout left
    out of the choice) and each panel's lines and 95% bands."""
    want = originals[name]
    result, panels, out = port_run(name, capsys)
    got = [[[float(n), {f"{m}|{s}": (None if v != v else v) for (m, s), v in stats.items()}]
            for n, stats in agg] for agg in result.values()]
    assert_close(got, want["aggregate"])
    assert_close(panels, want["figure"])
    assert out.splitlines()[-1] == want["stdout"].splitlines()[-1]
    if name == "overfit":  # the tie at 16 tasks goes to weight decay 0.1
        tie = [stats for n, stats in next(iter(result.values())) if n == 16][0]
        rows = sweep_rows(0, "sin", (0.0, 0.1, 0.5))
        means = {wd: np.nanmean([r["test_rmse_meta_train"] for r in rows
                                 if r["n_tasks"] == 16 and r["weight_decay"] == wd])
                 for wd in (0.1, 0.5)}
        assert means[0.1] != means[0.5]
        assert tie[("test_rmse_meta_train", "mean")] == pytest.approx(means[0.1], abs=TOL)


@pytest.mark.parametrize("name", ["n_tasks", "n_tasks_ll"])
def test_comparison_n_tasks_matches_the_original(originals, port_run, capsys, name):
    """The aggregate {family: {algo: [(n, mean, ci)]}} (NaN rows dropped,
    n_train_tasks from the dataset's name where no CSV has the column, the
    population std), the panels' lines, bands, ticks and labels, and the
    printed lines."""
    want = originals[name]
    result, panels, out = port_run(name, capsys)
    assert_close(json.loads(json.dumps(result)), want["aggregate"])
    assert_close(panels, want["figure"])
    assert out == want["stdout"]


@pytest.mark.parametrize("name", ["tasks", "tasks_all"])
def test_task_view_matches_the_original(originals, port_run, capsys, name):
    """The sampled tasks' lines and points, their colours, every panel's
    title and labels: exactly."""
    want = originals[name]
    _, panels, out = port_run(name, capsys)
    assert panels == want["figure"]
    assert out == want["stdout"]


BLOCKED = r'''
import importlib, sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("matplotlib", "pandas", "jax", "absl",
                                  "meta_learning_pacoh_tpu"):
            raise ImportError(f"No module named {name!r} (blocked)")


sys.meta_path.insert(0, Block())
for module, csv_flag in (("meta_overfitting.plot_meta_overfitting", "--csvs"),
                         ("comparison_n_tasks.plot_comparison_n_tasks", "--csv"),
                         ("visualization_tasks.visualize_sim_tasks", None)):
    mod = importlib.import_module("meta_learning_pacoh_torch.experiments." + module)
    argv = ["--output", "out.png"] + ([csv_flag, sys.argv[1]] if csv_flag else [])
    try:
        mod.main(argv)
    except ImportError as e:
        print(module, e)
    else:
        print(module, "ran")
'''


def test_scripts_fail_without_matplotlib(csvs, tmp_path):
    """With matplotlib (and pandas, JAX, absl) missing, each script's main
    raises on the import naming matplotlib, and no figure is written."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(csvs / "n_tasks.csv")],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 3 and all("No module named 'matplotlib" in ln for ln in lines), lines
    assert not (tmp_path / "out.png").exists()
